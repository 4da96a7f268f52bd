"""Arithmetic the metric readers share: phase times from the daemon's
stats, and the device shares of the traced steps (``trace.py``'s ranges,
the family reference's FLOP counts, ``roofline.py``'s bounds)."""

from __future__ import annotations

from portbench.roofline import (KV_BYTES, PEAK_OPS_PER_S, bound_s, k1_work,
                                k3_work)
from portbench.trace import parse_range


def phase_ms(ctx, names: tuple, count_of: str):
    """Host wall ms per call: the summed seconds of the worker's
    ``phase_stats`` entries ``names`` over the call count of
    ``count_of``."""
    ph = ctx.stats["phase_stats"]
    calls = ph.get(count_of, (0.0, 0))[1]
    if not calls:
        return None
    return sum(ph.get(n, (0.0, 0))[0] for n in names) / calls * 1e3


def idle_pct(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def traced_steps(ctx, kind: str) -> list[tuple[list[int], dict]]:
    """(counts, range entry) of each traced ``pb_<kind>`` range whose
    kernels ran in the trace."""
    out = []
    for r in ctx.trace["ranges"]:
        k, counts = parse_range(r["name"])
        if k == kind:
            out.append((counts, r))
    return out


def step_share(ctx, kind: str):
    """% of the bf16 peak reached by the traced steps of ``kind``
    ("decode": counts rows, keys; "prefill": rows, tokens, pairs)."""
    steps = traced_steps(ctx, kind)
    dev_s = sum(r["device_s"] for _, r in steps)
    if not steps or dev_s <= 0:
        return None
    fam, m = ctx.family, ctx.model
    if kind == "decode":
        flops = sum(fam.decode_flops(m, c[0], c[1]) for c, _ in steps)
    else:
        flops = sum(fam.prefill_flops(m, c[1], c[2], c[0]) for c, _ in steps)
    return 100.0 * flops / (dev_s * PEAK_OPS_PER_S["bf16"])


def kernel_roofline(ctx, kernel: str):
    """% of K1's or K3's least time that its summed device time in the
    traced steps reaches."""
    attn = ctx.family.attention_dims(ctx.model)
    if kernel == "k1":
        kvb = KV_BYTES[ctx.stats["kv_pool_dtype"]]
        steps = traced_steps(ctx, "decode")
        least = sum(bound_s(*k1_work(attn, c[0], c[1], kvb))
                    for c, _ in steps)
    else:
        steps = traced_steps(ctx, "prefill")
        least = sum(bound_s(*k3_work(attn, c[1], c[2])) for c, _ in steps)
    spent = sum(r[kernel] for _, r in steps)
    return 100.0 * least / spent if spent > 0 else None
