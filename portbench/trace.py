"""Reduction of the daemon's profiler trace to what the per-layer metrics
read: device busy time, the device time of each step the harness's ranges
mark, the time of the K1 and K3 kernels inside them, the device operations
that took most time and the longest idle gaps.

The daemon wrapper (``daemon.py``) records each worker call as a span
``pb_<kind>:<counts>`` on the profiler's clock; a kernel belongs to the span
inside which the host launched it: the kernel's CUPTI correlation id is its
launch call's (``cudaGraphLaunch`` for every kernel of a replayed graph).
Spans do not nest.
"""

from __future__ import annotations

import bisect
import dataclasses

#: substrings of the kernel names of K1 and K3 (``csrc/paged_decode.cu``,
#: ``csrc/ragged_prefill.cu``)
KERNELS = {"k1": "paged_decode_kernel", "k3": "ragged_prefill_kernel"}
RANGE_PREFIX = "pb_"


@dataclasses.dataclass
class Event:
    name: str
    device: bool        # a device activity (kernel, copy, set)
    start_ns: int
    end_ns: int
    corr: int


def from_kineto(events) -> list[Event]:
    """The profiler's raw events (``_disable_profiler().events()``) as
    ``Event``s."""
    out = []
    for e in events:
        s = int(e.start_ns())
        out.append(Event(e.name(), "CUDA" in str(e.device_type()), s,
                         s + int(e.duration_ns()), int(e.correlation_id())))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def short_name(name: str) -> str:
    """A kernel name without its argument list and return type."""
    base = name.split("(", 1)[0]
    if base.startswith("void "):
        base = base[5:]
    return base[:120]


def reduce_trace(events: list[Event], w0_ns: int, w1_ns: int,
                 top: int = 10) -> dict:
    """Summary of a trace over its window [w0_ns, w1_ns)."""
    dev = [e for e in events if e.device]
    host = [e for e in events if not e.device]
    ranges = sorted((e for e in host if e.name.startswith(RANGE_PREFIX)),
                    key=lambda e: e.start_ns)
    starts = [r.start_ns for r in ranges]

    def range_at(t: int):
        """The span covering host time t (only the latest to start can)."""
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and ranges[i].end_ns > t else None

    # launch calls (any host event that is not a range) -> their range
    corr_range: dict[int, int] = {}
    for e in host:
        if e.name.startswith(RANGE_PREFIX) or e.corr <= 0:
            continue
        i = range_at(e.start_ns)
        if i is not None:
            corr_range[e.corr] = i
    per_range = [{"name": r.name, "device_s": 0.0,
                  **{k: 0.0 for k in KERNELS}} for r in ranges]
    by_op: dict[str, float] = {}
    for e in dev:
        d = (e.end_ns - e.start_ns) / 1e9
        by_op[short_name(e.name)] = by_op.get(short_name(e.name), 0.0) + d
        i = corr_range.get(e.corr)
        if i is None:
            continue
        per_range[i]["device_s"] += d
        for k, sub in KERNELS.items():
            if sub in e.name:
                per_range[i][k] += d
    busy = _union([(max(e.start_ns, w0_ns), min(e.end_ns, w1_ns))
                   for e in dev if e.end_ns > w0_ns and e.start_ns < w1_ns])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    edges = [(w0_ns, w0_ns)] + busy + [(w1_ns, w1_ns)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            i = range_at(a)
            label = ("host: " + ranges[i].name.split(":", 1)[0]
                     if i is not None else "host: between steps")
            gaps.append((label, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1_ns - w0_ns) / 1e9,
        "busy_s": busy_s,
        "device_events": len(dev),
        "device_s_in_ranges": sum(r["device_s"] for r in per_range),
        "ranges": [r for r in per_range if r["device_s"] > 0],
        "device_ops": [[n, s] for n, s in ops[:top]],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
    }


def parse_range(name: str) -> tuple[str, list[int]]:
    """``pb_decode:12:3400`` -> ("decode", [12, 3400])."""
    kind, *counts = name[len(RANGE_PREFIX):].split(":")
    return kind, [int(c) for c in counts]
