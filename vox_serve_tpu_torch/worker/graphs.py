"""Captured decode steps: the port's counterpart of the JAX worker's
executable cache (vox_serve_tpu/worker/base.py ``_lm_fns``).

A decode step is a function of ONE packed int32 buffer on the device (the
pack layouts of the JAX worker's ``_build_lm_decode_fn`` and
``_unpack_multi``); it reads and writes the worker's persistent state in
place and returns its sampled tokens. ``StepCache`` holds one step per key
(``("decode", B, W)`` or ``("decode_multi", B, K, W)``), built at its first
use, as JAX compiles at first use, or at start-up by the worker's warmup.

On the card a key's step is a ``StepGraph``: a CUDA graph captured on the
cache's side stream after one warm-up call there, into the memory pool that
every graph of the cache shares, and replayed on the caller's stream. Its
input is a static device buffer, filled before each replay by one
asynchronous copy from a ring of pinned host buffers (a pageable or
captured host-to-device copy would synchronise or fail). Graphs that share
the pool and the worker's decode scratch replay in order on one stream;
their outputs are read (copied to the host) on that stream before the next
replay can reuse the pool. A failed capture raises: no step runs eagerly on
the card. On the CPU, which the tests use, a key's step is an
``EagerStep`` that runs the same body on every call.

Kernel launch counters (``ops/kernels.py``) are Python increments in the
wrappers, so a replay would not move them: a graph records the launches
its capture made (and takes them, and its warm-up call's, back off the
counters), then adds them on every replay.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..ops import kernels

#: a step body: packed int32 device buffer -> sampled tokens (device)
Body = Callable[[torch.Tensor], torch.Tensor]
#: key -> (body, a fully padded pack of the key's shape)
Builder = Callable[[tuple], tuple[Body, np.ndarray]]


class EagerStep:
    """A key's step where there is nothing to capture (the CPU): the body
    runs on each call."""

    def __init__(self, body: Body, device: torch.device):
        self.body = body
        self.device = device
        self.replays = 0

    def __call__(self, pack: np.ndarray) -> torch.Tensor:
        self.replays += 1
        return self.body(torch.from_numpy(pack).to(self.device))


class StepGraph:
    """One captured step on the card (see the module docstring)."""

    def __init__(self, body: Body, warm_pack: np.ndarray,
                 device: torch.device, pool, capture_stream: torch.cuda.Stream,
                 generator: torch.Generator, n_staging: int):
        self.device = device
        self.static_in = torch.from_numpy(warm_pack).to(device)
        self._staging = [torch.empty(warm_pack.shape, dtype=torch.int32,
                                     pin_memory=True)
                         for _ in range(max(n_staging, 1))]
        self._staged: list = [None] * len(self._staging)
        self._next = 0
        self.replays = 0

        stream = torch.cuda.current_stream(device)
        counts0 = kernels.launch_counts()
        # warm-up on the capture stream: fills the caches a first call
        # fills (cuBLAS workspaces, prepared weights) outside the graph
        capture_stream.wait_stream(stream)
        with torch.cuda.stream(capture_stream):
            body(self.static_in)
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # each replay advances the generator by the draws the step makes
        # (without this a replay would repeat the captured noise)
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=capture_stream):
            self.output = body(self.static_in)
        stream.wait_stream(capture_stream)
        after = kernels.launch_counts()
        wrappers = kernels.wrappers()
        #: (wrapper, launches) of one replay
        self.launches = [(wrappers[n], after[n] - before[n]) for n in after
                         if after[n] != before[n]]
        kernels.set_launch_counts(counts0)

    def __call__(self, pack: np.ndarray) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._staging)
        if self._staged[i] is not None:
            # the copy that last read this staging buffer must be done
            # before it is overwritten (the host may run steps ahead)
            self._staged[i].synchronize()
        self._staging[i].numpy()[...] = pack
        self.static_in.copy_(self._staging[i], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staged[i] = ev
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        self.replays += 1
        return self.output

    def probe_ms(self, n: int = 5) -> float:
        """Mean device ms per replay over n replays of the padded warm-up
        pack, after one discarded replay (the JAX warmup's probe). Probe
        replays are start-up measurements: no launch or replay is
        counted."""
        self.graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n


class StepCache:
    """Steps by key, built at first use (see the module docstring)."""

    def __init__(self, device: torch.device, build: Builder,
                 generator: torch.Generator, n_staging: int):
        self.device = device
        self._build = build
        self._generator = generator
        self._n_staging = n_staging
        self.steps: dict[tuple, EagerStep | StepGraph] = {}
        #: True while a step is warmed up or captured (its body then runs
        #: on the card outside any replay without being a served step)
        self.capturing = False
        #: seconds spent capturing (warm-up call, capture, instantiation)
        self.capture_s = 0.0
        #: key -> device ms per replay from the start-up probe
        self.probe_ms: dict[tuple, float] = {}
        self.pool = None
        self._capture_stream = None
        if device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(device)

    def get(self, key: tuple) -> EagerStep | StepGraph:
        step = self.steps.get(key)
        if step is None:
            body, warm_pack = self._build(key)
            if self.device.type != "cuda":
                step = EagerStep(body, self.device)
            else:
                t0 = time.perf_counter()
                self.capturing = True
                try:
                    step = StepGraph(body, warm_pack, self.device, self.pool,
                                     self._capture_stream, self._generator,
                                     self._n_staging)
                finally:
                    self.capturing = False
                self.capture_s += time.perf_counter() - t0
            self.steps[key] = step
        return step

    def run(self, key: tuple, pack: np.ndarray) -> torch.Tensor:
        return self.get(key)(pack)

    def probe(self, key: tuple) -> float:
        """Capture ``key`` if needed and time its replay (card only)."""
        ms = self.get(key).probe_ms()
        self.probe_ms[key] = ms
        return ms

    def replays(self) -> dict[str, int]:
        """Replays (eager calls on the CPU) per step kind."""
        out: dict[str, int] = {}
        for key, step in self.steps.items():
            out[key[0]] = out.get(key[0], 0) + step.replays
        return out

    def decode_steps(self) -> int:
        """Decode steps taken: one per single-step replay, k per fused
        replay."""
        return sum(step.replays * (key[2] if key[0] == "decode_multi" else 1)
                   for key, step in self.steps.items())

    def reset_counts(self) -> None:
        for step in self.steps.values():
            step.replays = 0

    def pool_bytes(self) -> int:
        """Bytes the shared graph pool holds (card only)."""
        snap = torch.cuda.memory._snapshot(self.device)
        return sum(seg["total_size"] for seg in snap["segments"]
                   if tuple(seg["segment_pool_id"]) == tuple(self.pool))
