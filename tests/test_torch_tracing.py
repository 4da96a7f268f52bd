"""The port's own timing on the CPU: each request's lifecycle stamps from
the API server's first frame to its first chunk, the scheduler round split
into wall time and waiting on the card (``phase_stats`` "round" and
"round.wait"), the bounded record of completed requests' stamps, and the
span recorder of ``--enable-profiling`` (nesting, Chrome trace events, the
profiler's clock), through an in-process online scheduler over the dummy
model and once through ``python -m vox_serve_tpu_torch.launch``.

On the CPU a step has no CUDA event, so the worker's blocking waits are
driven with a stand-in event whose ``synchronize`` sleeps.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.server.api import APIServer
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig
from vox_serve_tpu_torch.worker.spans import SpanRecorder

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("api", "recv", "prefill_dispatch", "first_detok", "first_audio")
#: a worker whose first chunk takes the cold chain (one stream, fused
#: decode, a 3-frame first chunk)
CHAIN = dict(fused_decode_steps=4, fused_decode_buckets=(1, 4),
             first_chunk_frames=3)


class _Event:
    """A CUDA event's stand-in: done at once, a short blocking wait."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        time.sleep(0.0002)


def _worker(profiling=False, **kw):
    w = ModelWorker(DummyLM(max_tokens=24), WorkerConfig(
        max_batch_size=4, num_pages=256, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=4,
        enable_profiling=profiling, **kw))
    w._event = lambda device=None: _Event()
    return w


def _api_frame(text: str) -> tuple[str, bytes]:
    """A request id and the first frame the API server builds for it."""
    api = APIServer.__new__(APIServer)
    api.dp_size, api.dead_ranks, api.dp_request_counter = 1, set(), 0
    frames = []
    api._register = lambda rid, entry, payload: frames.append(payload)
    rid = api.start_streaming_request(text=text)
    return rid, frames[0]


def _serve(s, n: int, texts=("one stream", "another stream")) -> list:
    """Send n API frames to the scheduler; run rounds until every request
    is done. Returns (did work, waits, wait seconds) of each round."""
    for t in texts[:n]:
        s._handle_message(_api_frame(t)[1])
    w, out = s.model_worker, []
    for _ in range(400):
        n0, t0 = w.waits, w.wait_s
        did = s._round()
        out.append((did, w.waits - n0, w.wait_s - t0))
        if not s.active_requests:
            break
    assert not s.active_requests
    return out


def test_round_counts_working_rounds_only():
    w = _worker()
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    for _ in range(3):
        assert not s._round()  # nothing to do: not a round of work
    assert "round" not in w.phase_stats
    rounds = _serve(s, 2)
    for _ in range(3):
        rounds.append((s._round(), 0, 0.0))
    assert not any(r[0] for r in rounds[-3:])
    work = [r for r in rounds if r[0]]
    wall, n = w.phase_stats["round"]
    wait, waits = w.phase_stats["round.wait"]
    assert n == len(work)
    assert waits == sum(r[1] for r in work) > 0
    assert wait == pytest.approx(sum(r[2] for r in work))
    assert 0 < wait <= wall
    # the other phase timers keep their names
    assert {"prefill", "decode.plan", "decode.dispatch",
            "decode.resolve"} <= set(w.phase_stats)
    assert not [k for k in w.phase_stats if k.startswith("sched.")]


@pytest.mark.parametrize("path", ["detokenize", "cold_chain"])
def test_stamps_are_ordered(path):
    """Every finished request's stamps, api <= recv <= prefill_dispatch <=
    first_detok <= first_audio, whether its first PCM came from a
    detokenize batch or from the cold chain."""
    w = _worker(**(CHAIN if path == "cold_chain" else {}))
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    _serve(s, 1 if path == "cold_chain" else 2)
    assert (w.cold_starts["chain"] > 0) == (path == "cold_chain")
    assert s.lifecycle
    for rec in s.lifecycle:
        t = [rec[k] for k in STAMPS]
        assert t == sorted(t), rec
    sent = [m.split(b"|", 1)[0].decode() for m in s._inproc_results
            if b"|COMPLETION|" in m]
    assert sorted(rec["rid"] for rec in s.lifecycle) == sorted(sent)
    # the COMPLETION message carries no timing any more
    for m in s._inproc_results:
        if b"|COMPLETION|" in m:
            assert set(json.loads(m.split(b"|", 2)[2])) == {"status",
                                                             "reason"}


def test_last_chunks_drained_at_completion_are_stamped():
    """A request whose only audio leaves in ``_send_completion``'s drain
    has its first_audio stamp."""
    w = _worker()
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    req = Request(request_id="drained", prompt="x", is_streaming=True)
    req.output_audio.put(b"\x00\x00" * 8)
    req.done_all = True
    s._send_completion(req)
    assert "first_audio" in s.lifecycle[-1]
    assert s.lifecycle[-1]["rid"] == "drained"


def test_frames_with_and_without_t_api():
    w = _worker()
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    rid, frame = _api_frame("hello")
    t = json.loads(frame.split(b"|", 1)[0])["t_api"]
    req = s._handle_request_payload(frame)
    assert req.request_id == rid and req.lifecycle == {"api": t}
    for extra in ({}, {"t_api": "soon"}):
        plain = json.dumps({"request_id": "p", "prompt": "hi",
                            "is_streaming": True, **extra}).encode()
        req = s._handle_request_payload(plain + b"|audio_data_placeholder")
        assert req.request_id == "p" and "api" not in req.lifecycle


def test_input_streaming_start_takes_its_stamps():
    from vox_serve_tpu_torch.scheduler.input_streaming import (
        InputStreamingScheduler)

    s = InputStreamingScheduler(model_worker=_worker(), max_batch_size=4,
                                connect=False)
    s._handle_message(b"ts|TEXT_STREAM_START|"
                      + json.dumps({"t_api": 5.0}).encode())
    req = s._streams["ts"]
    assert req.lifecycle["api"] == 5.0 and req.lifecycle["recv"] >= 5.0


def test_lifecycle_record_is_bounded():
    w = _worker()
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    assert s.lifecycle.maxlen == 8192
    for i in range(8200):
        req = Request(request_id=f"r{i}", prompt="x")
        req.done_all = True
        s._send_completion(req)
    assert len(s.lifecycle) == 8192
    assert s.lifecycle[0]["rid"] == "r8" and s.lifecycle[-1]["rid"] == "r8199"


def test_recorder_nests_dispatches_and_waits_under_rounds(tmp_path):
    w = _worker(profiling=True)
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    for _ in range(2):
        s._round()
    assert not w.spans.spans  # rounds without work are not recorded
    _serve(s, 2)
    spans = list(w.spans.spans)
    by_id = {sp.id: sp for sp in spans}
    rounds = [sp for sp in spans if sp.name == "round"]
    assert len(rounds) == w.phase_stats["round"][1]
    assert all(sp.parent is None for sp in rounds)
    names = {sp.name for sp in spans}
    assert "wait" in names
    for prefix in ("lm_prefill_t64_b", "lm_decode_b", "detokenize_b"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert sum(sp.name == "wait" for sp in spans) == \
        w.phase_stats["round.wait"][1]
    for sp in spans:
        if sp.name == "round":
            continue
        parent = by_id[sp.parent]
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns
        while parent.parent is not None:
            parent = by_id[parent.parent]
        assert parent.name == "round"
    path = tmp_path / "spans.json"
    w.spans.write(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert len(events) == len(spans)
    for e, sp in zip(events, spans):
        assert e["ph"] == "X" and e["name"] == sp.name
        assert e["ts"] == pytest.approx(sp.start_ns / 1e3)
        assert e["dur"] == pytest.approx((sp.end_ns - sp.start_ns) / 1e3)
        assert e["args"] == {"id": sp.id, "parent": sp.parent}


def test_recorder_off_records_nothing():
    w = _worker()
    s = load_scheduler("online", model_worker=w, max_batch_size=4,
                       connect=False)
    _serve(s, 2)
    assert w.spans is None
    assert w.phase_stats["round"][1] > 0


def test_recorder_bounds_and_dropped_spans():
    rec = SpanRecorder(limit=5)
    for i in range(8):
        with rec.span(f"s{i}"):
            pass
    assert [sp.name for sp in rec.spans] == ["s3", "s4", "s5", "s6", "s7"]
    # a span closed without being kept hands its children to its parent
    outer = rec.begin("outer")
    dropped = rec.begin("dropped")
    with rec.span("inner"):
        pass
    rec.end(dropped, keep=False)
    rec.end(outer)
    inner = [sp for sp in rec.spans if sp.name == "inner"][0]
    assert inner.parent == outer.id
    assert "dropped" not in {sp.name for sp in rec.spans}


def test_profiler_events_fall_inside_recorder_spans():
    """The recorder's stamps and the profiler's share the epoch clock: a
    ``record_function`` range opened inside a span starts and ends inside
    it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    rec = SpanRecorder()
    try:
        with rec.span("outer"):
            with torch.profiler.record_function("inside_outer"):
                torch.ones(64).sum()
    finally:
        result = _disable_profiler()
    outer = rec.spans[0]
    ev = [e for e in result.events() if e.name() == "inside_outer"]
    assert ev
    start = ev[0].start_ns()
    assert outer.start_ns <= start
    assert start + ev[0].duration_ns() <= outer.end_ns


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stats_file_and_spans_over_http(tmp_path):
    """Two streamed requests through the launcher with --enable-profiling:
    the stats file holds both requests' five ordered stamps, the API's
    among them, and the round timers; the span file loads, each round a
    top span."""
    import httpx

    port = _free_port()
    stats = tmp_path / "stats.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--max-batch-size", "2",
         "--max-num-pages", "64", "--page-size", "8",
         "--prefill-buckets", "64", "--socket-suffix", f"_trc{port}",
         "--max-tokens", "24", "--enable-profiling",
         "--stats-file", str(stats)], cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    rids = []
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "server died during startup"
            try:
                if httpx.get(base + "/health", timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.time() < deadline, "server did not become healthy"
            time.sleep(0.3)
        for text in ("first traced request", "second traced request"):
            with httpx.stream("POST", base + "/generate",
                              data={"text": text}, timeout=120) as r:
                assert r.status_code == 200
                disp = r.headers["Content-Disposition"]
                rids.append(disp.rsplit("stream_", 1)[-1].split(".")[0])
                assert b"".join(r.iter_bytes())[:4] == b"RIFF"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    spans_path = tmp_path / "stats.json.spans.json"
    for _ in range(100):
        if spans_path.exists() and spans_path.stat().st_size:
            break
        time.sleep(0.1)
    got = json.loads(stats.read_text())
    records = {rec["rid"][:8]: rec for rec in got["lifecycle"]}
    assert set(rids) <= set(records)
    for rid in rids:
        t = [records[rid][k] for k in STAMPS]
        assert t == sorted(t)
    wall, rounds = got["phase_stats"]["round"]
    assert rounds > 0 and 0 <= got["phase_stats"]["round.wait"][0] <= wall
    events = json.loads(spans_path.read_text())["traceEvents"]
    assert sum(e["name"] == "round" for e in events) == rounds
    assert all(e["args"]["parent"] is None for e in events
               if e["name"] == "round")
    assert any(e["name"].startswith("lm_prefill_t64") for e in events)
