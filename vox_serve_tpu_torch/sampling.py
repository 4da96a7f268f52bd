"""On-device sampling for the decode step (port of vox_serve_tpu/sampling.py).

Same strategy dispatch (greedy / top-k / top-p / combined / min-p) resolved
in Python from the static per-server ``SamplingConfig``, the same masks, and
the same repetition-penalty semantics: an appearance cache of shape
``(batch, window, n_codebooks, vocab)`` bool, OR-reduced over the window,
``logits > 0 -> /p`` and ``logits <= 0 -> *p``; ``window == -1`` means one
global plane that accumulates all generated tokens.

Random draws are Gumbel-max with noise from a ``torch.Generator`` (seeded by
the worker from ``WorkerConfig.seed``). They cannot match JAX's bits; masks
and greedy paths match exactly. Everything here is safe to capture in a
CUDA graph (no host reads, no shapes that depend on data); a graph that
samples registers the generator (``CUDAGraph.register_generator_state``,
``worker/graphs.py``), so that each replay draws new noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling configuration (per server run)."""

    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    temperature: float = 1.0
    max_tokens: Optional[int] = None
    repetition_penalty: Optional[float] = None
    repetition_window: Optional[int] = None  # -1 => global window
    cfg_scale: Optional[float] = None
    greedy: bool = False

    def replace(self, **kw) -> "SamplingConfig":
        return dataclasses.replace(self, **kw)

    @property
    def uses_repetition_penalty(self) -> bool:
        return (self.repetition_penalty is not None
                and self.repetition_penalty != 1.0)

    @property
    def cache_window(self) -> int:
        """Number of window slots held in the repetition cache (>=1)."""
        if self.repetition_window is None or self.repetition_window == -1:
            return 1
        return max(int(self.repetition_window), 1)

    @property
    def is_greedy(self) -> bool:
        return bool(self.greedy) or self.temperature == 0.0


# ---------------------------------------------------------------------------
# repetition penalty
# ---------------------------------------------------------------------------


def init_repetition_cache(batch: int, window: int, n_codebooks: int,
                          vocab: int, device: torch.device | str
                          ) -> torch.Tensor:
    """Fresh (all-False) appearance cache; per-request rows are zeroed at
    prefill by the worker."""
    return torch.zeros((batch, window, n_codebooks, vocab), dtype=torch.bool,
                       device=device)


def apply_repetition_penalty(logits: torch.Tensor, cache: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits: (B, C_l, V); cache: (B, W, C, V) bool. If C_l == 1 < C, the
    codebook-0 plane of the cache is used."""
    mask = torch.any(cache, dim=1)  # (B, C, V)
    if logits.shape[1] == 1 and mask.shape[1] != 1:
        mask = mask[:, :1, :]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(mask, penalized, logits)


def update_repetition_cache(cache: torch.Tensor, output_ids: torch.Tensor,
                            global_window: bool) -> torch.Tensor:
    """cache: (B, W, C, V) bool; output_ids: (B, C_ids) int.

    Windowed (W>1): shift left, last slot = one-hot of the new tokens.
    Global (window == -1, W == 1): OR the new tokens into the single plane.
    If C_ids == 1 but C > 1, only the codebook-0 plane is touched."""
    B, W, C, V = cache.shape
    c_ids = output_ids.shape[1]
    # a compare, not one_hot: no range check that could read the device
    onehot = output_ids.long()[..., None] == torch.arange(
        V, device=output_ids.device)
    if c_ids == 1 and C != 1:
        plane = torch.cat(
            [onehot, torch.zeros((B, C - 1, V), dtype=torch.bool,
                                 device=cache.device)], dim=1)
    else:
        plane = onehot  # (B, C, V)
    if W > 1:
        return torch.cat([cache[:, 1:], plane[:, None]], dim=1)
    if global_window:
        return cache | plane[:, None]
    return plane[:, None]


# ---------------------------------------------------------------------------
# filtering primitives
# ---------------------------------------------------------------------------


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep only the k largest logits along the last axis; k <= 0 is the
    'disabled' convention (no-op)."""
    k = min(int(k), logits.shape[-1])
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the minimal prefix of the descending-prob
    distribution whose cumulative mass reaches p (the crossing token is
    kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < p
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def _mask_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    return torch.where(probs < top * min_p,
                       torch.full_like(logits, NEG_INF), logits)


def _gumbel_sample(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max: argmax(logits + G), G = -log(E), E ~ Exp(1) drawn from
    ``generator`` (which must live on the logits' device)."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    e.exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def sample(logits: torch.Tensor, config: SamplingConfig,
           generator: Optional[torch.Generator],
           repetition_cache: torch.Tensor | None = None) -> torch.Tensor:
    """Sample int32 ids of shape logits.shape[:-1] from logits (..., V).

    Strategy order: greedy | T==0 -> argmax; top_k & top_p -> combined
    (top_k first); top_k; top_p; min_p; fallback greedy."""
    logits = logits.float()
    if repetition_cache is not None and config.uses_repetition_penalty:
        logits = apply_repetition_penalty(
            logits, repetition_cache, float(config.repetition_penalty))

    if config.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits = logits / float(config.temperature)

    # top_p >= 1.0 keeps the whole distribution: skip the sort
    top_p = config.top_p if (config.top_p is not None
                             and config.top_p < 1.0) else None
    if config.top_k is not None and top_p is not None:
        logits = _mask_top_k(logits, config.top_k)
        logits = _mask_top_p(logits, top_p)
    elif config.top_k is not None:
        logits = _mask_top_k(logits, config.top_k)
    elif top_p is not None:
        logits = _mask_top_p(logits, top_p)
    elif config.top_p is not None:
        pass  # top_p == 1.0 alone: full distribution
    elif config.min_p is not None:
        logits = _mask_min_p(logits, float(config.min_p))
    else:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return _gumbel_sample(logits, generator)


def sample_and_update(logits: torch.Tensor, config: SamplingConfig,
                      generator: Optional[torch.Generator],
                      repetition_cache: torch.Tensor | None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """sample() + repetition cache update. Returns (ids, new_cache)."""
    ids = sample(logits, config, generator, repetition_cache)
    new_cache = repetition_cache
    if repetition_cache is not None and config.uses_repetition_penalty:
        ids2d = ids if ids.dim() == 2 else ids[:, None]
        new_cache = update_repetition_cache(
            repetition_cache, ids2d,
            global_window=(config.repetition_window in (None, -1)))
    return ids, new_cache
