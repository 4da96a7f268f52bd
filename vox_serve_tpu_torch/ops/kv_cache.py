"""Paged KV cache: one fixed-shape device pool + a host-side page allocator
(port of vox_serve_tpu/ops/kv_cache.py).

The pool is the combined token-major layout ``(L, P, page, 2*KH, D)`` in
bf16, K at even and V at odd combined-head indices, so one token's write is
one contiguous ``(2*KH, D)`` row and one page holds every head's K and V for
``page`` tokens. Page 0 is a reserved scratch page that padded batch rows
and page-table padding point at. The JAX package's zero-padding of sub-128
head dims up to 128 lanes (``store_dim``) is a TPU lane artefact and is not
carried over: rows are stored at the head dim.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def pool_shape(self) -> tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_pages, self.page_size,
                2 * self.num_kv_heads, self.head_dim)


def alloc_kv_pages(cfg: KVCacheConfig, device: torch.device | str
                   ) -> torch.Tensor:
    """Allocate the zero-filled combined pool on ``device``."""
    return torch.zeros(cfg.pool_shape, dtype=cfg.dtype, device=device)


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
