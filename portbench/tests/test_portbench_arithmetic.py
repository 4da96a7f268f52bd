"""The end-to-end metrics' arithmetic on hand-made chunk timings, and the
trace reduction on hand-made events."""

import math
import statistics

import pytest

from portbench import stats
from portbench.client import Request, Timeline
from portbench.trace import Event, parse_range, reduce_trace

SR = 24000
BYTES_PER_S = SR * 2


def _req(due, chunks, failed=False):
    r = Request("x", due)
    r.status = 200
    r.done = not failed
    for t, n in chunks:
        if r.first_pcm_t is None:
            r.first_pcm_t = t
        r.last_pcm_t = t
        r.pcm_bytes += n
        r.chunks.append((t, n))
    if failed:
        r.error = "closed"
    return r


@pytest.mark.parametrize("q", [0, 5, 25, 50, 75, 95, 100])
def test_percentile_matches_linear_interpolation(q):
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    v = sorted(vals)
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    want = v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (pos - lo)
    assert stats.percentile(vals, q) == pytest.approx(want)
    if q == 50:
        assert stats.percentile(vals, q) == statistics.median(vals)


def test_percentile_counts_failures_as_infinite():
    vals = [1.0] * 18 + [stats.INF] * 2
    assert stats.percentile(vals, 50) == 1.0
    assert stats.percentile(vals, 95) == stats.INF
    assert stats.percentile([stats.INF, stats.INF], 50) == stats.INF


def test_ttfa_from_the_due_time():
    r = _req(10.0, [(10.25, 960), (10.5, 960)])
    assert stats.ttfa_s(r) == pytest.approx(0.25)
    assert stats.ttfa_s(_req(10.0, [(10.3, 960)], failed=True)) == stats.INF


def test_stream_rtf():
    # 2 s of audio over the 1 s from first to last byte
    r = _req(0.0, [(1.0, BYTES_PER_S), (2.0, BYTES_PER_S)])
    assert stats.stream_rtf(r, SR) == pytest.approx(2.0)
    assert stats.stream_rtf(_req(0.0, [(1.0, 10)], failed=True), SR) == 0.0
    assert stats.stream_rtf(_req(0.0, [(1.0, 10)]), SR) == stats.INF


def test_audio_in_window_counts_chunks_by_arrival():
    a = _req(0.0, [(0.5, BYTES_PER_S), (1.5, BYTES_PER_S)])
    b = _req(1.0, [(1.9, BYTES_PER_S // 2), (3.0, BYTES_PER_S)])
    assert stats.audio_in_window([a, b], 1.0, 2.0, SR) == pytest.approx(1.5)


def test_readers_over_a_window():
    from portbench import spec

    tl = Timeline(0.0, 1.0, 3.0, 10.0)

    class Ctx:
        pass

    ctx = Ctx()
    ctx.timeline = tl
    ctx.sample_rate = SR
    ctx.window_requests = [_req(1.0 + i * 0.1, [(1.2 + i * 0.1, BYTES_PER_S),
                                                (1.7 + i * 0.1, BYTES_PER_S)])
                           for i in range(10)]
    ctx.requests = ctx.window_requests
    assert spec.reader("ttfa_p50_ms")(ctx) == pytest.approx(200.0)
    assert spec.reader("ttfa_p95_ms")(ctx) == pytest.approx(200.0)
    assert spec.reader("stream_rtf_p5")(ctx) == pytest.approx(4.0)
    # 20 chunks of 1 s, all inside [1, 3)
    assert spec.reader("audio_s_per_s")(ctx) == pytest.approx(10.0)


def test_trace_reduction():
    ms = 1_000_000
    ev = [
        Event("pb_decode:4:400", False, 0, 10 * ms, 1),
        Event("cudaGraphLaunch", False, 1 * ms, 2 * ms, 7),
        Event("pb_prefill:2:50:700", False, 12 * ms, 20 * ms, 2),
        Event("cudaGraphLaunch", False, 13 * ms, 14 * ms, 9),
        Event("void paged_decode_kernel<2>(x)", True, 2 * ms, 4 * ms, 7),
        Event("gemm", True, 4 * ms, 8 * ms, 7),
        Event("ragged_prefill_kernel<4, false>(y)", True, 14 * ms, 15 * ms,
              9),
        Event("gemm", True, 15 * ms, 18 * ms, 9),
    ]
    t = reduce_trace(ev, 0, 20 * ms)
    assert t["busy_s"] == pytest.approx(0.010)
    assert t["window_s"] == pytest.approx(0.020)
    dec, pre = t["ranges"]
    assert dec["device_s"] == pytest.approx(0.006)
    assert dec["k1"] == pytest.approx(0.002) and dec["k3"] == 0
    assert pre["device_s"] == pytest.approx(0.004)
    assert pre["k3"] == pytest.approx(0.001)
    assert parse_range(pre["name"]) == ("prefill", [2, 50, 700])
    # the gaps: [0, 2) in the decode step, [8, 14) partly between steps
    labels = dict((round(s, 6), n) for n, s in t["idle_gaps"])
    assert labels[0.006] == "host: pb_decode"
    assert labels[0.002] in ("host: pb_decode", "host: pb_prefill")
    assert t["device_ops"][0][0] == "gemm"
