"""1-D conv primitives for audio codecs (port of
vox_serve_tpu/codecs/layers.py).

Weights keep torch's layouts, which the JAX package already uses: Conv1d
``(out, in/groups, k)``, ConvTranspose1d ``(in, out/groups, k)``. Activations
are NCH (``(B, C, T)``) throughout; the JAX package's channels-last variants
were a TPU lane-layout device and are not carried over.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def init_conv1d(generator: torch.Generator, in_ch: int, out_ch: int,
                kernel: int, device, groups: int = 1, bias: bool = True,
                dtype: torch.dtype = torch.float32) -> dict:
    """Uniform(-s, s) init with s = (in/groups * k)^-1/2 (JAX init)."""
    scale = 1.0 / math.sqrt(in_ch // groups * kernel)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return ((u * 2.0 - 1.0) * scale).to(dtype)

    p = {"w": uniform((out_ch, in_ch // groups, kernel))}
    if bias:
        p["b"] = uniform((out_ch,))
    return p


def init_conv_transpose1d(generator: torch.Generator, in_ch: int,
                          out_ch: int, kernel: int, device, groups: int = 1,
                          bias: bool = True,
                          dtype: torch.dtype = torch.float32) -> dict:
    scale = 1.0 / math.sqrt(out_ch // groups * kernel)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return ((u * 2.0 - 1.0) * scale).to(dtype)

    p = {"w": uniform((in_ch, out_ch // groups, kernel))}
    if bias:
        p["b"] = uniform((out_ch,))
    return p


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding=0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x: (B, C_in, T) -> (B, C_out, T'). padding: int (symmetric) or
    (left, right). Matches torch.nn.Conv1d; params set the compute dtype."""
    x = x.to(p["w"].dtype)
    if not isinstance(padding, int):
        x = F.pad(x, (padding[0], padding[1]))
        padding = 0
    return F.conv1d(x, p["w"], p.get("b"), stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(p: dict, x: torch.Tensor, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """Matches torch.nn.ConvTranspose1d (weight layout (in, out/groups, k))."""
    x = x.to(p["w"].dtype)
    return F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride,
                              padding=padding, output_padding=output_padding,
                              groups=groups, dilation=dilation)


def causal_conv(p: dict, x: torch.Tensor, pad: int, cache, dilation: int = 1,
                groups: int = 1):
    """Causal conv1d -> (y, new cache). Without a cache the input is
    zero-padded by ``pad`` on the left; with one, the cache (the last
    ``pad`` input samples) is prepended and the new cache is the last
    ``pad`` samples of that."""
    if cache is None:
        xin = F.pad(x, (pad, 0))
        new_cache = None
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=-1)
        new_cache = xin[:, :, -pad:] if pad > 0 else cache
    y = conv1d(p, xin, padding=0, dilation=dilation, groups=groups)
    return y, new_cache


def rvq_decode(group: dict, codes: torch.Tensor) -> torch.Tensor:
    """Residual-VQ decode of one quantizer group (codebook = embed_sum /
    usage; the entries summed over quantizers, then the group's 1x1 output
    projection): codes (B, n_q, T) -> (B, out_dim, T)."""
    embed = group["embed_sum"] / torch.clamp(group["usage"],
                                             min=1e-5)[..., None]
    q_idx = torch.arange(embed.shape[0], device=codes.device)[None, :, None]
    q = embed[q_idx, codes.long()]              # (B, n_q, T, vq_dim)
    return conv1d(group["out_proj"], q.sum(dim=1).transpose(1, 2))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(a x) / (a + 1e-9), computed in float32
    and returned in x's dtype. alpha: (C,) or (1, C, 1)."""
    if alpha.dim() == 1:
        alpha = alpha[None, :, None]
    xf = x.float()
    af = alpha.float()
    out = xf + (1.0 / (af + 1e-9)) * torch.sin(af * xf).square()
    return out.to(x.dtype)


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Fold torch weight_norm (g, v) into a plain weight: w = g * v/||v||,
    norm over all dims except dim 0."""
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)
    return (g.reshape(-1) / np.maximum(norm, 1e-12)).reshape(
        [-1] + [1] * (v.ndim - 1)) * v
