"""The port's scheduler daemon with the harness's hooks:
``python -m portbench.daemon <scheduler_entry flags>`` (started by
``serve.py`` in place of ``python -m vox_serve_tpu_torch.scheduler_entry``).

Runs ``vox_serve_tpu_torch.scheduler_entry.main`` unchanged, after three
hooks, all configured by environment variables the harness sets:

* ``PORTBENCH_CTL`` (a directory, always): each request's served tokens
  (every sampled row, stop row included), prompt, detokenize windows and
  finish reason are written, one JSON line per completed request, to
  ``records.jsonl`` there by a writer thread (the daemon's loop only puts
  the request on a queue). The daemon writes its pid to ``pid``.
* step counters (always): prefill calls and rows, decode calls and rows;
  written to ``counts.json`` once the harness creates
  ``counts_request`` (a thread polls for it).
* ``PORTBENCH_TRACE=1``: SIGUSR2 starts, then stops, the profiler (CUDA
  activity: kernels, copies and their launch calls) on the daemon's main
  thread; while it runs each worker call is a span
  ``pb_prefill:<rows>:<tokens>:<causal pairs>``,
  ``pb_decode:<rows>:<keys read>`` or ``pb_detok:<requests>`` on the
  profiler's clock; a thread reduces the trace and the spans
  (``trace.py``) and writes ``trace.json``.
* ``PORTBENCH_FAULT=token|pcm`` (the fault tests only): alter one sampled
  token of every request where it is produced, or negate one PCM chunk of
  every request where it is sent.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import sys
import threading
import time
from pathlib import Path


def _record_writer(path: Path, q: "queue.Queue") -> None:
    with open(path, "a") as f:
        while True:
            req = q.get()
            rec = {
                "rid": req.request_id,
                "prompt": req.prompt,
                "input_length": int(req.input_length),
                "tokens": [[int(x) for x in row]
                           for row in req.lm_output_tokens],
                "audio_tokens": len(req.lm_output_audio_tokens),
                "windows": [list(w) for w in
                            req.extras.get("detok_windows", [])],
                "finish_reason": req.finish_reason,
            }
            f.write(json.dumps(rec) + "\n")
            f.flush()


def install_records(ctl: Path) -> None:
    from vox_serve_tpu_torch.scheduler.base import Scheduler

    q: "queue.Queue" = queue.Queue()
    threading.Thread(target=_record_writer, args=(ctl / "records.jsonl", q),
                     daemon=True).start()
    orig = Scheduler._send_completion

    def send_completion(self, req):
        first = not req.extras.get("completion_sent")
        orig(self, req)
        if first:
            q.put(req)

    Scheduler._send_completion = send_completion


COUNTS = dict.fromkeys(("prefill_calls", "prefill_rows", "decode_calls",
                        "decode_rows"), 0)
#: (name, start ns, end ns) of each marked worker call while the profiler
#: runs (the wall clock the profiler's events are stamped with)
SPANS: list = []
TRACING = [False]


def _counts_writer(ctl: Path) -> None:
    while not (ctl / "counts_request").exists():
        time.sleep(0.1)
    tmp = ctl / "counts.json.tmp"
    tmp.write_text(json.dumps(dict(COUNTS)))
    tmp.rename(ctl / "counts.json")


class _Span:
    """Records one marked call in ``SPANS`` while the profiler runs."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns() if TRACING[0] else None

    def __exit__(self, *exc):
        if self.t0 is not None:
            SPANS.append((self.name, self.t0, time.time_ns()))


def install_steps() -> None:
    """Count the worker's prefill and decode calls and rows, and mark each
    prefill, decode and detokenize call as a span while the profiler
    runs."""
    from vox_serve_tpu_torch.worker.base import ModelWorker

    dispatch_prefill = ModelWorker._dispatch_prefill
    run_lm_decode = ModelWorker.run_lm_decode
    run_detokenize = ModelWorker.run_detokenize

    def _dispatch_prefill(self, requests, arr):
        COUNTS["prefill_calls"] += 1
        COUNTS["prefill_rows"] += len(requests)
        if not TRACING[0]:
            return dispatch_prefill(self, requests, arr)
        lens = [int(r.input_length) for r in requests]
        tri = sum(n * (n + 1) // 2 for n in lens)
        with _Span(f"pb_prefill:{len(lens)}:{sum(lens)}:{tri}"):
            return dispatch_prefill(self, requests, arr)

    def _run_lm_decode(self, requests):
        COUNTS["decode_calls"] += 1
        COUNTS["decode_rows"] += len(requests)
        if not TRACING[0]:
            return run_lm_decode(self, requests)
        keys = sum(int(r.next_position_id) for r in requests)
        with _Span(f"pb_decode:{len(requests)}:{keys}"):
            return run_lm_decode(self, requests)

    def _run_detokenize(self, requests):
        if not TRACING[0]:
            return run_detokenize(self, requests)
        with _Span(f"pb_detok:{len(requests)}"):
            return run_detokenize(self, requests)

    ModelWorker._dispatch_prefill = _dispatch_prefill
    ModelWorker.run_lm_decode = _run_lm_decode
    ModelWorker.run_detokenize = _run_detokenize


class _Profiler:
    """Starts and stops the profiler (CUDA activity: kernels, copies and
    the runtime calls that launched them) on SIGUSR2."""

    def __init__(self, ctl: Path):
        self.ctl = ctl
        self.on = False
        self.t0_ns = 0

    def toggle(self, signum, frame) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _disable_profiler,
                                    _enable_profiler, _prepare_profiler)

        if not self.on:
            cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                 False, False, _ExperimentalConfig())
            acts = ({ProfilerActivity.CUDA} if torch.cuda.is_available()
                    else {ProfilerActivity.CPU})
            _prepare_profiler(cfg, acts)
            _enable_profiler(cfg, acts)
            SPANS.clear()
            self.t0_ns = time.time_ns()
            TRACING[0] = self.on = True
            return
        # the window ends before the profiler's own collection starts
        t1_ns = time.time_ns()
        TRACING[0] = self.on = False
        result = _disable_profiler()
        threading.Thread(target=self._reduce, args=(result, t1_ns),
                         daemon=True).start()

    def _reduce(self, result, t1_ns: int) -> None:
        """Reduce the trace once the harness asks for the step counts
        (after the window's drain), so the reduction takes no host time
        from the window."""
        from portbench.trace import Event, from_kineto, reduce_trace

        while not (self.ctl / "counts_request").exists():
            time.sleep(0.1)
        try:
            t = time.perf_counter()
            events = from_kineto(result.events()) + [
                Event(n, False, a, b, 0) for n, a, b in SPANS]
            summary = reduce_trace(events, self.t0_ns, t1_ns)
            summary["reduce_s"] = time.perf_counter() - t
        except Exception as e:  # the harness reads the error and fails
            summary = {"error": repr(e)}
        tmp = self.ctl / "trace.json.tmp"
        tmp.write_text(json.dumps(summary))
        tmp.rename(self.ctl / "trace.json")


def install_fault(kind: str) -> None:
    """Break the served path underneath (the fault tests): ``token`` adds 1
    to codebook 0 of each request's fifth sampled row where it is
    produced; ``pcm`` negates each request's second PCM chunk where it is
    sent."""
    import numpy as np
    from vox_serve_tpu_torch.models.base import BaseLM
    from vox_serve_tpu_torch.scheduler.base import Scheduler

    if kind == "token":
        orig = BaseLM.update_request_state

        def update_request_state(self, req, sampled):
            if len(req.lm_output_tokens) == 4:
                sampled = np.array(sampled, copy=True)
                sampled[0] = (int(sampled[0]) + 1) % 2048
            return orig(self, req, sampled)

        BaseLM.update_request_state = update_request_state
    elif kind == "pcm":
        orig_send = Scheduler._send

        def _send(self, message: bytes) -> None:
            rid, kind_, data = message.split(b"|", 2)
            if kind_ == b"AUDIO":
                n = self.__dict__.setdefault("_pb_sent", {})
                n[rid] = n.get(rid, 0) + 1
                if n[rid] == 2:
                    pcm = -np.frombuffer(data, np.int16).astype(np.int32)
                    data = np.clip(pcm, -32768, 32767).astype(
                        np.int16).tobytes()
                    message = rid + b"|AUDIO|" + data
            return orig_send(self, message)

        Scheduler._send = _send
    else:
        raise SystemExit(f"unknown PORTBENCH_FAULT {kind!r}")


def main(argv=None) -> None:
    ctl = Path(os.environ["PORTBENCH_CTL"])
    (ctl / "pid").write_text(str(os.getpid()))
    traced = os.environ.get("PORTBENCH_TRACE") == "1"
    install_records(ctl)
    install_steps()
    threading.Thread(target=_counts_writer, args=(ctl,), daemon=True).start()
    if os.environ.get("PORTBENCH_FAULT"):
        install_fault(os.environ["PORTBENCH_FAULT"])
    if traced:
        signal.signal(signal.SIGUSR2, _Profiler(ctl).toggle)
    from vox_serve_tpu_torch import scheduler_entry

    scheduler_entry.main(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
