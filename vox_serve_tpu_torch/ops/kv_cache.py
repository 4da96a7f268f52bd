"""Paged KV cache: fixed-shape device pools + a host-side page allocator
(port of vox_serve_tpu/ops/kv_cache.py).

Two layouts, as in the JAX package:

* combined (what the worker serves unless the layout rule or
  ``VOX_KV_COMBINED=0`` says otherwise): one token-major pool
  ``(L, P, page, 2*KH, D)``, K at even and V at odd combined-head indices,
  so one token's write is one contiguous ``(2*KH, D)`` row and one page
  holds every head's K and V for ``page`` tokens. It may be quantized (int8 with static scales, or
  float8 e4m3) and is read by K1 / K1q.
* pair (legacy, head-major): ``k, v: (L, KH, P, page, D)`` each, read by K4.

Page 0 is a reserved scratch page that padded batch rows and page-table
padding point at. The JAX package's zero-padding of sub-128 head dims up to
128 lanes (``store_dim``) is a TPU lane artefact and is not carried over:
rows are stored at the head dim.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16
    #: combined token-major layout (see alloc_kv_pages); the worker picks
    #: it with combined_kv_supported
    combined: bool = False
    #: quantized pool storage: "none" (store at `dtype`), "f8_e4m3"
    #: (scale-free float8: clip to +-448 and cast), or "int8" (symmetric,
    #: static per-tensor amax via k_amax/v_amax). Combined layout only; the
    #: fresh K/V of a step stay full precision through prefill attention,
    #: only the pool is quantized.
    quant: str = "none"
    #: int8: values are stored as round(x / (amax/127)), clipped to +-127
    k_amax: float = 16.0
    v_amax: float = 16.0

    def __post_init__(self):
        if self.quant not in ("none", "f8_e4m3", "int8"):
            raise ValueError(f"unknown kv quant mode {self.quant!r}")
        if self.quant != "none" and not self.combined:
            raise ValueError("quantized KV requires the combined layout")

    @property
    def pool_dtype(self) -> torch.dtype:
        """Storage dtype of the page pool (quantized or `dtype`)."""
        if self.quant == "f8_e4m3":
            return torch.float8_e4m3fn
        if self.quant == "int8":
            return torch.int8
        return self.dtype

    @property
    def kv_scales(self) -> Optional[tuple[float, float]]:
        """(k_scale, v_scale) dequant multipliers for the decode kernel and
        the gather path, or None when the pool is unquantized."""
        if self.quant == "f8_e4m3":
            return (1.0, 1.0)
        if self.quant == "int8":
            return (self.k_amax / 127.0, self.v_amax / 127.0)
        return None


def combined_kv_supported(head_dim: int, num_kv_heads: int,
                          dtype=torch.bfloat16) -> bool:
    """Whether (head_dim, KH) uses the combined token-major pool layout.

    The JAX package's rule, unchanged, so that the same model under the
    same flags picks the same layout in both packages. The rule is a TPU
    tiling one (head_dim up to 128 lanes; the combined 2*KH axis tileable
    at the KV dtype's sublane packing); K1/K1q themselves take any head
    dim up to 128 in steps of 8."""
    if head_dim > 128:
        return False
    packing = {1: 4, 2: 2, 4: 1}.get(dtype.itemsize, 1)
    x = 2 * num_kv_heads
    if x % packing:
        return False
    x //= packing
    return x in (1, 2, 4, 8) or x % 8 == 0


def alloc_kv_pages(cfg: KVCacheConfig, device: torch.device | str
                   ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Allocate the zero-filled pool(s) on ``device``: ``(pool, None)`` for
    the combined layout, the ``(k, v)`` pair, each ``(L, KH, P, page, D)``,
    for the legacy one."""
    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.pool_dtype, device=device)

    if cfg.combined:
        return zeros((cfg.num_layers, cfg.num_pages, cfg.page_size,
                      2 * cfg.num_kv_heads, cfg.head_dim)), None
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.num_pages, cfg.page_size,
             cfg.head_dim)
    return zeros(shape), zeros(shape)


class PageAllocatorError(RuntimeError):
    pass


class PageAllocator:
    """Host-side O(1) free-list page allocator.

    Page 0 is reserved (scratch page for padded batch slots and page-table
    padding). Exhaustion raises a typed error so the scheduler can apply
    admission control.
    """

    SCRATCH_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...
        self._free_set = set(self._free)  # O(1) double-free detection
        # pages promised to admitted requests for their generation budget but
        # not yet materialized; admission control counts them as spoken-for so
        # decode-phase page growth can never hit exhaustion mid-stream
        self._reserved = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_unreserved(self) -> int:
        return len(self._free) - self._reserved

    def alloc(self, n: int = 1, reserved: int = 0) -> list[int]:
        """Take n pages; `reserved` of them draw down this caller's prior
        reservation (the rest must fit the unreserved pool)."""
        reserved = min(reserved, n, self._reserved)
        if n - reserved > self.num_unreserved:
            raise PageAllocatorError(
                f"KV page pool exhausted: requested {n} ({reserved} reserved)"
                f", free {len(self._free)} (reserved {self._reserved})"
            )
        self._reserved -= reserved
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, pages: list[int]) -> None:
        # validate EVERYTHING before mutating: a partial free on error would
        # leak the tail of the list; a double-free would hand the same page
        # to two live requests (silent KV corruption)
        for p in pages:
            if p == self.SCRATCH_PAGE:
                raise PageAllocatorError("cannot free the scratch page")
            if not 0 < p < self.num_pages:
                raise PageAllocatorError(f"page {p} out of range")
            if p in self._free_set:
                raise PageAllocatorError(f"double free of page {p}")
        if len(set(pages)) != len(pages):
            raise PageAllocatorError("duplicate pages in one free() call")
        self._free.extend(pages)
        self._free_set.update(pages)

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_unreserved

    # -- generation-budget reservations (admission control) ---------------
    def can_reserve(self, n: int) -> bool:
        return n <= self.num_unreserved

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise PageAllocatorError(
                f"cannot reserve {n} pages: free {len(self._free)}, "
                f"already reserved {self._reserved}")
        self._reserved += n

    def release_reservation(self, n: int) -> None:
        self._reserved = max(self._reserved - n, 0)
