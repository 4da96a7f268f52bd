"""A rehearsal of a run on the CPU: the harness's launcher and daemon
hooks around ``python -m vox_serve_tpu_torch.launch --model dummy --device
cpu``, both traffic loops at a tiny load, the records and counts the
daemon wrapper writes, the stats file, and every process stopped."""

import os

import pytest

from portbench.client import Sender
from portbench.run import (Hooks, Server, read_records, request_counts,
                           wait_file)
from portbench.spec import HERE
from portbench.traffic import Traffic

ROOT = HERE.parent
CONF = {"launch": ["--model", "dummy", "--device", "cpu",
                   "--max-batch-size", "4"]}


def _mix(loop):
    return {"loop": loop, "clients": 3, "rate_per_s": 4.0,
            "prompt_chars": {"min": 10, "max": 30}, "form": {},
            "warm_in_s": 1.0, "drain_limit_s": 30.0}


@pytest.mark.parametrize("loop,trace", [("closed", False), ("open", True)])
def test_rehearsal(tmp_path, loop, trace):
    server = Server(ROOT, tmp_path, CONF, 2**31 + 5, trace)
    try:
        server.wait_ready(180)
        hooks = Hooks(server, trace, 1)
        hooks.sample_memory = lambda: None  # no nvidia-smi here
        d = Sender(f"http://127.0.0.1:{server.port}",
                   Traffic(_mix(loop), 2**31 + 5), 0.5, 4.0, 30.0,
                   hooks.on_tick)
        d.run()
        win = d.window_requests()
        assert win and not [r for r in win if r.failed]
        assert all(r.pcm_bytes == len(r.pcm) for r in win)
        heard = [r for r in win if r.pcm_bytes]
        assert heard and all(r.first_pcm_t >= r.send_t >= r.due_t - 0.5
                             for r in heard)
        counts = request_counts(tmp_path / "counts.json")
        records = read_records(tmp_path / "records.jsonl")
        assert {r.rid8 for r in win} <= set(records)
        for r in win:
            rec = records[r.rid8]
            assert rec["prompt"] == r.text
            assert rec["audio_tokens"] * 2 * 240 >= r.pcm_bytes
        assert counts["prefill_rows"] >= len(win)
        assert counts["decode_rows"] >= counts["decode_calls"] > 0
        if trace:
            summary = wait_file(tmp_path / "trace.json", 60)
            # the CPU runs no device operation
            assert summary["device_events"] == 0 and "window_s" in summary
    finally:
        server.stop()
    pid = int((tmp_path / "pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert server.proc.poll() is not None
    stats = __import__("json").loads((tmp_path / "stats.json").read_text())
    # the daemon goes on serving the requests still open after the counts
    assert stats["phase_stats"]["prefill"][1] >= counts["prefill_calls"]
    assert stats["steps"]["decode_steps"] >= counts["decode_calls"]
