"""Peaks of the card and the least time the work of a kernel or a step
needs, counted from what its inputs need (each input byte read once, each
output byte written once; the padding of a bucket left out), whatever
kernel does it.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W power
limit (dense rates); a card held to a lower ``power.limit`` reaches less,
and every result line names the card's limit beside the shares. The bound
arithmetic is ``chip_smoke.py``'s ``bound``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12}
KV_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
            "float8_e4m3fn": 1}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """The least seconds: bytes over the memory rate or operations over
    the peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def k1_work(attn: dict, rows: int, keys: int, kv_bytes: int
            ) -> tuple[float, float]:
    """(bytes, operations) of paged decode attention over every layer for
    ``rows`` queries that read ``keys`` KV positions in all: each key and
    value read once, each query read and each output written once."""
    H, KH, D, L = (attn["heads"], attn["kv_heads"], attn["head_dim"],
                   attn["layers"])
    nbytes = L * (keys * KH * D * 2 * kv_bytes + rows * H * D * 2 * 2)
    return nbytes, L * 4.0 * H * D * keys


def k3_work(attn: dict, tokens: int, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of causal prefill attention over every layer
    for ``tokens`` prompt tokens with ``pairs`` causal (query, key) pairs:
    q, k, v read once and o written once, in bf16."""
    H, KH, D, L = (attn["heads"], attn["kv_heads"], attn["head_dim"],
                   attn["layers"])
    return (L * tokens * (2 * H + 2 * KH) * D * 2.0,
            L * 4.0 * H * D * pairs)
