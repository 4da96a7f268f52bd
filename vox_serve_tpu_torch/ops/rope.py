"""Rotary position embeddings (port of vox_serve_tpu/ops/rope.py).

Split-half rotation (HF Llama/Qwen convention) with optional partial rotary
(``rope_dim < head_dim``); Qwen3 uses theta = 1e6, Orpheus's Llama-3.2-3B
theta = 5e5 with Llama-3.1 frequency scaling. The interleaved (ChatGLM)
variant belongs to a family that is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str = "cpu",
                     llama31_scaling: bool = False,
                     scale_factor: float = 8.0,
                     low_freq_factor: float = 1.0,
                     high_freq_factor: float = 4.0,
                     old_context_len: int = 8192) -> torch.Tensor:
    """Per-pair inverse frequencies, shape (head_dim // 2,), float32.
    ``llama31_scaling``: Llama-3.1's rule, with the JAX package's constants
    (long wavelengths divided by ``scale_factor``, short ones kept, a
    smooth blend between)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    if llama31_scaling:
        low_wavelen = old_context_len / low_freq_factor
        high_wavelen = old_context_len / high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (old_context_len / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor)
        blend = ((1.0 - smooth) * inv_freq / scale_factor
                 + smooth * inv_freq)
        inv_freq = torch.where(
            wavelen > low_wavelen, inv_freq / scale_factor,
            torch.where(wavelen < high_wavelen, inv_freq, blend))
    return inv_freq


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, rope_dim: Optional[int] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k by position.

    q: (T, H, D); k: (T, KH, D); positions: (T,) int. With rope_dim < D only
    the first rope_dim dims rotate; the rest pass through."""
    D = q.shape[-1]
    rd = rope_dim if rope_dim is not None else D
    angles = positions[:, None].float() * inv_freq[None, :rd // 2]
    cos = torch.cos(angles)[:, None, :]  # (T, 1, rd/2)
    sin = torch.sin(angles)[:, None, :]

    def rot(x: torch.Tensor) -> torch.Tensor:
        xr, xp = x[..., :rd], x[..., rd:]
        x1 = xr[..., : rd // 2].float()
        x2 = xr[..., rd // 2:].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
        if rd < D:
            out = torch.cat([out, xp], dim=-1)
        return out

    return rot(q), rot(k)
