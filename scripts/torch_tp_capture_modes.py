"""Which ``torch.cuda.graph`` capture mode holds NCCL collectives.

The tensor-parallel worker (``vox_serve_tpu_torch/parallel/ranks.py``)
captures ``torch.distributed`` broadcasts and all-reduces inside every LM
step graph, on every rank. While a thread captures, the NCCL watchdog
thread of ``ProcessGroupNCCL`` queries the events of earlier collectives;
under the ``global`` capture mode such a call from another thread can
invalidate the capture. For each mode this script starts one process per
card (a fresh group each time, so that a failed capture leaves nothing
behind), joins them in an NCCL group with one eager all-reduce, then on
each rank, as ``worker/graphs.py`` does, makes a warm-up call on a side
stream and captures a graph of a broadcast and two all-reduces there,
replays it three times with new inputs and checks the sums. It prints one
JSON line per mode: each rank's "ok" or its error.

    python3 scripts/torch_tp_capture_modes.py [--ranks 4]
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import socket
import traceback

MODES = ("global", "thread_local", "relaxed")


def _rank(rank: int, size: int, port: int, mode: str, queue) -> None:
    import torch
    import torch.distributed as dist

    try:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=120))
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        x = torch.zeros(4, 256, device=dev)
        a = torch.zeros(4, 256, device=dev)

        def body():
            dist.broadcast(x, src=0)
            y = a + x
            dist.all_reduce(y)
            dist.all_reduce(y)
            return y

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            out = body()
        for step in range(3):
            a.fill_(rank + 1.0)
            if rank == 0:
                x.fill_(float(step))
            graph.replay()
            torch.cuda.synchronize()
            # (sum of rank + 1 + size * step) summed again over the ranks
            want = size * (size * (size + 1) / 2 + size * step)
            if not torch.allclose(out, torch.full_like(out, want)):
                raise AssertionError(f"replay {step}: {out[0, 0].item()} "
                                     f"!= {want}")
        queue.put((rank, "ok"))
    except BaseException:
        queue.put((rank, traceback.format_exc(limit=3)))
    # no destroy_process_group: a rank that leaves the group after rank 0's
    # store has gone waits on it
    queue.close()
    queue.join_thread()
    os._exit(0)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (one card each); default every card")
    args = ap.parse_args()
    size = args.ranks or torch.cuda.device_count()
    ctx = multiprocessing.get_context("spawn")
    for mode in MODES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, size, port, mode, queue))
                 for r in range(size)]
        for p in procs:
            p.start()
        results = {}
        for _ in procs:
            try:
                rank, res = queue.get(timeout=180)
                results[rank] = res
            except Exception:  # a rank hung: the mode failed
                break
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        print(json.dumps({"mode": mode, "ranks": size,
                          "results": {r: results.get(r, "no answer")
                                      for r in range(size)}}), flush=True)


if __name__ == "__main__":
    main()
