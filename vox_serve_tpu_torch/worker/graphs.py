"""Captured worker steps: the port's counterpart of the JAX worker's
executable caches (vox_serve_tpu/worker/base.py ``_lm_fns`` and
``_detok_fns``).

A step is a function of a few host arrays, the first always ONE packed
int32 buffer (the pack layouts of the JAX worker's ``_unpack_prefill``,
``_build_lm_decode_fn``, ``_unpack_multi`` and the detokenize upload);
prefill and the cold chain add the model's float feature and bool mask
planes. A step reads and writes the worker's persistent state in place and
returns a tensor or a tuple of tensors (sampled tokens, int16 PCM).
``StepCache`` holds one step per key, built at its first use, as JAX
compiles at first use, or at start-up by the worker's warmup. The keys:
``("prefill", T, B)``, ``("decode", B, W)``, ``("decode_multi", B, K,
W)``, ``("decode_multi_detok", B, K, W)``, ``("cold_chain", T, K)`` and
``("detok", B, L)``.

On the card a key's step is a ``StepGraph``: a CUDA graph captured on the
cache's side stream after one warm-up call there, into the memory pool that
every graph of the cache shares, and replayed on the caller's stream. Each
input is a static device buffer, filled before each replay by one
asynchronous copy from a ring of pinned host buffers (a pageable or
captured host-to-device copy would synchronise or fail). Graphs that share
the pool and the worker's decode scratch replay in order on one stream. A
graph's outputs are static buffers that its next replay overwrites: the
caller copies them to the host on the stream right after the replay. A
failed capture raises: no step runs eagerly on the card. On the CPU, which
the tests use, a key's step is an ``EagerStep`` that runs the same body on
every call.

Kernel counters (``ops/kernels.py``: every wrapper's ``launches``, K2's
``stacks``) are Python increments in the wrappers, so a replay would not
move them: a graph records what its capture counted (and takes that, and
its warm-up call's counts, back off the counters), then adds it on every
replay.
"""

from __future__ import annotations

import time
from typing import Callable, Union

import numpy as np
import torch

from ..ops import kernels

Output = Union[torch.Tensor, tuple]
#: a step body: its device inputs -> its outputs (device)
Body = Callable[..., Output]
#: key -> (body, fully padded inputs of the key's shapes)
Builder = Callable[[tuple], tuple[Body, tuple[np.ndarray, ...]]]

#: decode steps one replay takes, by step kind (key[2] holds k)
_DECODE_STEPS = {"decode": lambda key: 1,
                 "decode_multi": lambda key: key[2],
                 "decode_multi_detok": lambda key: key[2],
                 "cold_chain": lambda key: key[2]}


def increments(before: dict, after: dict) -> list:
    """(wrapper, counter, increment) for every kernel counter that moved
    between two ``kernels.counters()`` readings."""
    wrappers = kernels.wrappers()
    return [(wrappers[name], field, after[name, field] - before[name, field])
            for name, field in after
            if after[name, field] != before[name, field]]


def add_counts(counts: list) -> None:
    """Add ``increments`` output to the counters (one replay's worth)."""
    for fn, field, n in counts:
        setattr(fn, field, getattr(fn, field) + n)


class EagerStep:
    """A key's step where there is nothing to capture (the CPU): the body
    runs on each call."""

    def __init__(self, body: Body, device: torch.device):
        self.body = body
        self.device = device
        self.replays = 0
        self.counts: list = []

    def __call__(self, *inputs: np.ndarray) -> Output:
        self.replays += 1
        return self.body(*(torch.from_numpy(a).to(self.device)
                           for a in inputs))


class StepGraph:
    """One captured step on the card (see the module docstring)."""

    def __init__(self, body: Body, warm_inputs: tuple[np.ndarray, ...],
                 device: torch.device, pool, capture_stream: torch.cuda.Stream,
                 generator: torch.Generator, n_staging: int):
        self.device = device
        self.static_in = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in warm_inputs]
        self._staging = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in self.static_in]
                         for _ in range(max(n_staging, 1))]
        self._staged: list = [None] * len(self._staging)
        self._next = 0
        self.replays = 0

        stream = torch.cuda.current_stream(device)
        counts0 = kernels.counters()
        # warm-up on the capture stream: fills the caches a first call
        # fills (cuBLAS workspaces, prepared weights) outside the graph
        capture_stream.wait_stream(stream)
        with torch.cuda.stream(capture_stream):
            body(*self.static_in)
        before = kernels.counters()
        self.graph = torch.cuda.CUDAGraph()
        # each replay advances the generator by the draws the step makes
        # (without this a replay would repeat the captured noise)
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=capture_stream):
            self.output = body(*self.static_in)
        stream.wait_stream(capture_stream)
        #: (wrapper, counter, increment) of one replay
        self.counts = increments(before, kernels.counters())
        kernels.set_counters(counts0)

    def __call__(self, *inputs: np.ndarray) -> Output:
        i = self._next
        self._next = (i + 1) % len(self._staging)
        if self._staged[i] is not None:
            # the copies that last read these staging buffers must be done
            # before they are overwritten (the host may run steps ahead)
            self._staged[i].synchronize()
        for buf, a, dst in zip(self._staging[i], inputs, self.static_in):
            buf.numpy()[...] = a
            dst.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staged[i] = ev
        self.graph.replay()
        add_counts(self.counts)
        self.replays += 1
        return self.output

    def probe_ms(self, n: int = 5) -> float:
        """Mean device ms per replay over n replays of the padded warm-up
        inputs, after one discarded replay (the JAX warmup's probe). Probe
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
        #: kind -> [first, last] ordinal of its runs among all runs since
        #: the last reset (the order in which step kinds were issued)
        self.spans: dict[str, list[int]] = {}
        self._runs = 0
        self.pool = None
        self._capture_stream = None
        if device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(device)

    def get(self, key: tuple) -> EagerStep | StepGraph:
        step = self.steps.get(key)
        if step is None:
            body, warm_inputs = self._build(key)
            if self.device.type != "cuda":
                step = EagerStep(body, self.device)
            else:
                t0 = time.perf_counter()
                self.capturing = True
                try:
                    step = StepGraph(body, warm_inputs, self.device,
                                     self.pool, self._capture_stream,
                                     self._generator, self._n_staging)
                finally:
                    self.capturing = False
                self.capture_s += time.perf_counter() - t0
            self.steps[key] = step
        return step

    def run(self, key: tuple, *inputs: np.ndarray) -> Output:
        step = self.get(key)
        self._runs += 1
        self.spans.setdefault(key[0], [self._runs, self._runs])[1] = self._runs
        return step(*inputs)

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
        """Decode steps taken: one per single-step replay, k per fused,
        chained or cold-chain replay."""
        return sum(step.replays * _DECODE_STEPS[key[0]](key)
                   for key, step in self.steps.items()
                   if key[0] in _DECODE_STEPS)

    def captured_counts(self) -> dict[str, dict[str, int]]:
        """Per key (space-joined): its replays and the kernel counters one
        replay adds (``name.counter``; none on the CPU)."""
        return {" ".join(map(str, key)): {
            "replays": step.replays,
            **{f"{fn.__name__}.{field}": n for fn, field, n in step.counts}}
            for key, step in self.steps.items()}

    def reset_counts(self) -> None:
        for step in self.steps.values():
            step.replays = 0
        self.spans.clear()
        self._runs = 0

    def pool_bytes(self) -> int:
        """Bytes the shared graph pool holds (card only)."""
        snap = torch.cuda.memory._snapshot(self.device)
        return sum(seg["total_size"] for seg in snap["segments"]
                   if tuple(seg["segment_pool_id"]) == tuple(self.pool))
