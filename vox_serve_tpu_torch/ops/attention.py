"""Attention for continuous batching over the paged KV pool (port of
vox_serve_tpu/ops/attention.py, combined-pool layout only).

* ``ragged_prefill_attention``: prompts concatenated token-wise into one
  T-token buffer with segment ids; causal within each segment. Prefill always
  starts from an empty KV (new requests), so it never reads the pool; K/V
  are written to pages on the side for the decode phase.
* ``paged_attention_decode``: one query per request attends over its block
  table in the combined ``(L, P, page, 2KH, D)`` pool.

Both dispatch on the tensor's device through ``ops/kernels.py``: CPU
tensors take the plain PyTorch versions, CUDA tensors the hand-written
kernels (K3 and K1). KV writes scatter by host-planned (page, offset);
padded rows target scratch page 0.
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
    # prefill
    segment_ids: Optional[torch.Tensor] = None
    q_positions: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# KV page writes
# ---------------------------------------------------------------------------


def write_kv_prefill(pool: torch.Tensor, layer: int, k: torch.Tensor,
                     v: torch.Tensor, meta: AttnMetadata) -> torch.Tensor:
    """Scatter T new K/V rows into the combined pool at ``layer``, IN PLACE
    (the JAX version returns a new pool; updating in place saves a pool
    copy per layer). k, v: (T, KH, D). K/V interleave on the combined-head
    axis (K even, V odd) so each token's write is one contiguous (2KH, D)
    row. Padded tokens target scratch page 0. Returns ``pool``."""
    T, KH, D = k.shape
    kv = torch.stack([k, v], dim=2).reshape(T, 2 * KH, D)  # k0,v0,k1,v1...
    pool[layer, meta.kv_page_ids.long(), meta.kv_page_offsets.long()] = \
        kv.to(pool.dtype)
    return pool


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
                            meta: AttnMetadata,
                            scale: float | None = None) -> torch.Tensor:
    """Plain gather path over the combined pool (the CPU route and the
    reference K1 is held against)."""
    return kernels.paged_decode_attention_plain(
        q, pool, layer, meta.block_tables, meta.seq_lens, scale)


def paged_attention_decode(q: torch.Tensor, pool: torch.Tensor, layer: int,
                           meta: AttnMetadata,
                           scale: float | None = None) -> torch.Tensor:
    """q: (B, H, D); returns (B, H, D). seq_lens already includes the
    current token, whose K/V must be written before calling this."""
    return kernels.paged_decode_attention(q, pool, layer, meta.block_tables,
                                          meta.seq_lens, scale)
