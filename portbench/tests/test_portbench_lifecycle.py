"""The readers of the daemon's stamps and round timers
(``portbench/lifecycle.py`` and its eight metrics): the join and the
arithmetic on a hand-made context, None where a record or a stamp is
missing (a program without them), and a CPU rehearsal that reads all
eight from a real stats file."""

import json
import types

import pytest

from portbench import lifecycle, spec
from portbench.client import Request, Sender
from portbench.run import Hooks, Server
from portbench.traffic import Traffic

ROOT = spec.HERE.parent
TTFA_PARTS = ("ttfa_api_ms", "ttfa_intake_ms", "ttfa_queue_ms",
              "ttfa_frames_ms", "ttfa_detok_ms", "ttfa_hop_out_ms")
METRICS = TTFA_PARTS + ("round_host_ms", "round_wait_ms")


def _req(rid8, due, send, first, failed=False):
    r = Request("x", due)
    r.rid8, r.send_t, r.status, r.done = rid8, send, 200, True
    r.first_pcm_t = first
    if failed:
        r.error = "closed"
    return r


def _ctx():
    reqs = [_req("aaaaaaaa", 10.0, 10.001, 10.61),
            _req("bbbbbbbb", 10.05, 10.0502, 10.93),
            _req("cccccccc", 10.1, 10.1003, None),        # no audio
            _req("dddddddd", 10.2, 10.2, 11.0, failed=True)]
    recs = [
        {"rid": "aaaaaaaa-1", "api": 10.003, "recv": 10.03,
         "prefill_dispatch": 10.05, "first_detok": 10.55,
         "first_audio": 10.6},
        {"rid": "bbbbbbbb-2", "api": 10.0531, "recv": 10.09,
         "prefill_dispatch": 10.2, "first_detok": 10.8,
         "first_audio": 10.9},
    ]
    stats = {"lifecycle": recs,
             "phase_stats": {"round": [12.0, 200], "round.wait": [4.5, 380],
                             "prefill": [1.0, 10]}}
    return types.SimpleNamespace(window_requests=reqs, stats=stats)


def test_parts_add_up_to_the_mean_ttfa():
    ctx = _ctx()
    parts = lifecycle.ttfa_parts_ms(ctx)
    a, b = ctx.stats["lifecycle"]
    assert parts["api"] == pytest.approx(
        ((a["api"] - 10.001) + (b["api"] - 10.0502)) / 2 * 1e3)
    assert parts["queue"] == pytest.approx(((0.02) + (0.11)) / 2 * 1e3)
    assert parts["hop_out"] == pytest.approx(((0.01) + (0.03)) / 2 * 1e3)
    total = sum(parts[k] for k in lifecycle.PARTS) + parts["late"]
    assert total == pytest.approx(parts["ttfa"], abs=1e-9)
    assert parts["ttfa"] == pytest.approx(((0.61) + (0.88)) / 2 * 1e3)
    for name in TTFA_PARTS:
        part = name[len("ttfa_"):-len("_ms")]
        assert spec.reader(name)(ctx) == parts[part]


def test_round_split():
    ctx = _ctx()
    assert spec.reader("round_host_ms")(ctx) == pytest.approx(37.5)
    assert spec.reader("round_wait_ms")(ctx) == pytest.approx(22.5)
    del ctx.stats["phase_stats"]["round.wait"]
    assert spec.reader("round_host_ms")(ctx) is None
    ctx.stats["phase_stats"] = {"round": [0.0, 0], "round.wait": [0.0, 0]}
    assert spec.reader("round_wait_ms")(ctx) is None


@pytest.mark.parametrize("gap", ["no_key", "no_record", "no_stamp"])
def test_none_when_a_record_or_stamp_is_missing(gap):
    ctx = _ctx()
    if gap == "no_key":
        del ctx.stats["lifecycle"]
    elif gap == "no_record":
        ctx.stats["lifecycle"].pop()
    else:
        del ctx.stats["lifecycle"][0]["first_detok"]
    for name in TTFA_PARTS:
        assert spec.reader(name)(ctx) is None


def test_rehearsal_reads_all_eight(tmp_path):
    """The harness's launcher and daemon around ``--model dummy --device
    cpu`` at a tiny open-loop load: every metric non-null from the stats
    file, and every part of every joined request non-negative (the
    client's and the daemon's stamps on one clock, in the order a request
    passes them)."""
    conf = {"launch": ["--model", "dummy", "--device", "cpu",
                       "--max-batch-size", "4"]}
    mix = {"loop": "open", "rate_per_s": 2.0,
           "prompt_chars": {"min": 10, "max": 20}, "form": {},
           "warm_in_s": 1.0, "drain_limit_s": 30.0}
    server = Server(ROOT, tmp_path, conf, 2**31 + 11, False)
    try:
        server.wait_ready(180)
        hooks = Hooks(server, False, 1)
        hooks.sample_memory = lambda: None  # no nvidia-smi here
        sender = Sender(f"http://127.0.0.1:{server.port}",
                        Traffic(mix, 2**31 + 11), 0.5, 2.0, 30.0,
                        hooks.on_tick)
        sender.run()
    finally:
        server.stop()
    stats = json.loads((tmp_path / "stats.json").read_text())
    ctx = types.SimpleNamespace(window_requests=sender.window_requests(),
                                stats=stats)
    assert [r for r in ctx.window_requests if r.first_pcm_t is not None]
    values = {m: spec.reader(m)(ctx) for m in METRICS}
    assert all(v is not None for v in values.values()), values
    assert all(v >= 0 for v in values.values()), values
    rows = lifecycle.request_parts_ms(ctx)
    assert len(rows) == len([r for r in ctx.window_requests
                             if not r.failed and r.first_pcm_t is not None])
    assert all(v >= 0 for row in rows for v in row.values()), rows
