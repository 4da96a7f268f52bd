"""Normalization ops (port of vox_serve_tpu/ops/norms.py). The f32 upcasts
sit exactly where the JAX versions put them: statistics and the affine
product in float32, one cast back to the input dtype at the end."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to x.dtype.

    offset=1.0 gives the Gemma-style (1 + w) parameterization."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight.float() + offset)).to(dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed.to(dtype)
