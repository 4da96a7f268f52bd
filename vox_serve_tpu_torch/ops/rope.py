"""Rotary position embeddings (port of vox_serve_tpu/ops/rope.py).

Split-half rotation (HF Llama/Qwen convention) with optional partial rotary
(``rope_dim < head_dim``); Qwen3 uses theta = 1e6. The interleaved
(ChatGLM) variant and Llama-3.1 frequency scaling belong to families that
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-pair inverse frequencies, shape (head_dim // 2,), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


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
