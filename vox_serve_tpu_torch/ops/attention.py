"""Attention for continuous batching over the paged KV pool (port of
vox_serve_tpu/ops/attention.py).

* ``ragged_prefill_attention``: prompts concatenated token-wise into one
  T-token buffer with segment ids; causal within each segment. Prefill always
  starts from an empty KV (new requests), so it never reads the pool; K/V
  are written to pages on the side for the decode phase.
* ``paged_attention_decode``: one query per request attends over its block
  table, in the combined ``(L, P, page, 2KH, D)`` pool (full precision or
  quantized to int8 / float8 e4m3) or the legacy head-major pair
  ``k, v: (L, KH, P, page, D)``.

All dispatch on the tensor's device through ``ops/kernels.py``: CPU
tensors take the plain PyTorch versions, CUDA tensors the hand-written
kernels (K3 for prefill; K1, K1q or K4 for decode by pool layout and type).
KV writes scatter in place by host-planned (page, offset); padded rows
target scratch page 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import kernels


@dataclasses.dataclass
class AttnMetadata:
    """Per-step attention metadata (device tensors, host-planned).

    Decode (one token per request, batch B):
      block_tables: (B, max_pages) int32 — page ids per request, pad = 0
      seq_lens:     (B,) int32 — tokens in KV *including* this step's token
      kv_page_ids / kv_page_offsets: (B,) int32 — where this step's K/V goes
      decode_scratch: the worker's ``kernels.DecodeScratch`` for split
        decode launches on the card (None: one per launch)
      linear_scratch: the worker's ``kernels.W8A16Scratch`` for split K5
        launches of an int8 backbone on the card (None: one per launch);
        prefill passes it too

    Prefill (ragged, T tokens total):
      segment_ids:  (T,) int32 — request index per token; padding = -1
      q_positions:  (T,) int32 — position of each token within its segment
      kv_page_ids / kv_page_offsets: (T,) int32 — scatter targets (pad -> 0)
    """

    is_prefill: bool
    kv_page_ids: torch.Tensor
    kv_page_offsets: torch.Tensor
    # decode
    block_tables: Optional[torch.Tensor] = None
    seq_lens: Optional[torch.Tensor] = None
    decode_scratch: Optional[kernels.DecodeScratch] = None
    linear_scratch: Optional[kernels.W8A16Scratch] = None
    # prefill
    segment_ids: Optional[torch.Tensor] = None
    q_positions: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# KV page writes
# ---------------------------------------------------------------------------


def _quantize_kv(k: torch.Tensor, v: torch.Tensor, pool_dtype: torch.dtype,
                 kv_scales: Optional[tuple[float, float]]):
    """Quantize fresh K/V rows for a quantized pool (kv_cache.py quant):
    f8_e4m3 clips to the format's +-448 range and casts (a cast of an
    out-of-range value would give NaN); int8 stores round(x / scale)
    (half to even) clipped to +-127. No-op for full-precision pools."""
    if pool_dtype == torch.int8:
        ks, vs = kv_scales
        k = torch.clamp(torch.round(k.float() / ks), -127, 127)
        v = torch.clamp(torch.round(v.float() / vs), -127, 127)
        return k.to(torch.int8), v.to(torch.int8)
    if pool_dtype == torch.float8_e4m3fn:
        k = torch.clamp(k.float(), -448.0, 448.0)
        v = torch.clamp(v.float(), -448.0, 448.0)
        return k.to(pool_dtype), v.to(pool_dtype)
    return k, v


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """float8 tensors are scattered through a uint8 view (bit-identical;
    index_put_ may not take float8 on every backend)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def write_kv_prefill(k_pages: torch.Tensor, v_pages: Optional[torch.Tensor],
                     layer: int, k: torch.Tensor, v: torch.Tensor,
                     meta: AttnMetadata,
                     kv_scales: Optional[tuple[float, float]] = None) -> None:
    """Scatter T new K/V rows into the pool(s) at ``layer``, IN PLACE (the
    JAX version returns new pools; updating in place saves a pool copy per
    layer). k, v: (T, KH, D). Padded tokens target scratch page 0.

    Combined layout (``v_pages`` None): K/V quantize to the pool's type and
    interleave on the combined-head axis (K even, V odd) so each token's
    write is one contiguous (2KH, D) row. Pair layout: ``k_pages`` and
    ``v_pages`` are (L, KH, P, page, D)."""
    ids = meta.kv_page_ids.long()
    offs = meta.kv_page_offsets.long()
    if v_pages is None:
        T, KH, D = k.shape
        k, v = _quantize_kv(k, v, k_pages.dtype, kv_scales)
        kv = torch.stack([k, v], dim=2).reshape(T, 2 * KH, D)  # k0,v0,k1,..
        _bytes(k_pages)[layer, ids, offs] = _bytes(kv.to(k_pages.dtype))
        return
    k_pages[layer][:, ids, offs] = k.to(k_pages.dtype).transpose(0, 1)
    v_pages[layer][:, ids, offs] = v.to(v_pages.dtype).transpose(0, 1)


# decode writes share the same signature/semantics (B rows instead of T)
write_kv_decode = write_kv_prefill


# ---------------------------------------------------------------------------
# prefill and decode attention (dispatch by device)
# ---------------------------------------------------------------------------


def ragged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, meta: AttnMetadata,
                             scale: float | None = None) -> torch.Tensor:
    """q: (T, H, D); k, v: (T, KH, D); returns (T, H, D) in q.dtype.
    Token i attends j iff seg[i] == seg[j] >= 0 and j <= i (segments are
    contiguous spans, so buffer order is position order)."""
    return kernels.ragged_prefill_attention(q, k, v, meta.segment_ids, scale)


def _combined_decode_gather(q: torch.Tensor, pool: torch.Tensor, layer: int,
                            meta: AttnMetadata, scale: float | None = None,
                            kv_scales: Optional[tuple[float, float]] = None
                            ) -> torch.Tensor:
    """Plain gather path over the combined pool, dequantizing a quantized
    one with the static ``kv_scales`` (the CPU route and the reference K1
    and K1q are held against)."""
    return kernels.paged_decode_attention_plain(
        q, pool, layer, meta.block_tables, meta.seq_lens, scale, kv_scales)


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: Optional[torch.Tensor], layer: int,
                           meta: AttnMetadata, scale: float | None = None,
                           kv_scales: Optional[tuple[float, float]] = None
                           ) -> torch.Tensor:
    """q: (B, H, D); returns (B, H, D). seq_lens already includes the
    current token, whose K/V must be written before calling this.

    ``v_pages`` None: ``k_pages`` is the combined pool (K1, or K1q with the
    (k_scale, v_scale) dequant multipliers of a quantized pool). Otherwise
    the legacy head-major pair (K4)."""
    if v_pages is None:
        return kernels.paged_decode_attention(
            q, k_pages, layer, meta.block_tables, meta.seq_lens, scale,
            kv_scales, meta.decode_scratch)
    return kernels.paged_decode_attention_pair(
        q, k_pages, v_pages, layer, meta.block_tables, meta.seq_lens, scale,
        meta.decode_scratch)
