"""The rate sweep that fixes an open-loop cell's offered rate:

    python3 -m portbench.sweep --workload <cell> --seed <n> \\
        --rates 8,16,24 --seconds 15

One server of the cell's configuration; for each rate in turn the cell's
traffic at that rate (its warm-in, a window of ``--seconds``, the drain).
Per rate it prints one JSON line: the rate offered, requests due in the
window and failed, time to first audio (median, 95th percentile, and the
median of the window's first and second halves: a rise between them is a
growing backlog), the 5th percentile real-time factor, and the requests
still open when the window closed. The cell's traffic file then takes 0.8
of the highest rate without a growing backlog.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

from portbench import spec
from portbench.client import Sender
from portbench.run import Hooks, Server, device_info, log
from portbench.stats import percentile, stream_rtf, ttfa_s
from portbench.traffic import Traffic


def summarize(sender: Sender, rate: float, sample_rate: int) -> dict:
    tl = sender.timeline
    win = sender.window_requests()
    mid = (tl.t0 + tl.t1) / 2
    first = [ttfa_s(r) for r in win if r.due_t < mid]
    second = [ttfa_s(r) for r in win if r.due_t >= mid]
    open_at_t1 = sum(1 for r in sender.requests
                     if r.send_t < tl.t1 and (r.last_pcm_t or 0) >= tl.t1)
    return {
        "rate": rate, "due": len(win),
        "failed": sum(r.failed for r in win),
        "ttfa_p50_ms": percentile([ttfa_s(r) for r in win], 50) * 1e3,
        "ttfa_p95_ms": percentile([ttfa_s(r) for r in win], 95) * 1e3,
        "ttfa_first_half_p50_ms": percentile(first, 50) * 1e3,
        "ttfa_second_half_p50_ms": percentile(second, 50) * 1e3,
        "stream_rtf_p5": percentile([stream_rtf(r, sample_rate)
                                     for r in win], 5),
        "open_at_window_end": open_at_t1,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root, False)
    device_info(cell.chips)
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-sweep-"))
    server = Server(root, run_dir, cell.config, args.seed, False)
    try:
        log(f"set-up {server.wait_ready(240):.2f} s")
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(cell.traffic, rate_per_s=rate, drain_limit_s=30.0)
            sender = Sender(f"http://127.0.0.1:{server.port}",
                            Traffic(mix, args.seed), mix["warm_in_s"],
                            args.seconds, mix["drain_limit_s"],
                            Hooks(server, False, cell.chips).on_tick)
            sender.run()
            out = summarize(sender, rate, cell.config["sample_rate"])
            print(json.dumps(out), flush=True)
    finally:
        server.stop()
        shutil.rmtree(run_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
