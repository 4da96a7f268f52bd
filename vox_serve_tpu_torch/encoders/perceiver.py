"""Perceiver resampler: a variable-length prompt -> a fixed number of
conditioning rows (port of vox_serve_tpu/encoders/perceiver.py).

Learned latent queries attend over the concatenation of the projected
prompt features and themselves (the perceiver-resampler convention), with
padded prompt positions masked to -1e30, so the output shape does not
depend on the prompt's length. Chatterbox's dev conditioning path
(``ChatterboxLM._cond_fn``) runs it where an upload arrives but no
``cond_enc.*`` weights were loaded.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear
from ..ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    in_dim: int = 1024
    hidden: int = 1024
    heads: int = 16
    layers: int = 2
    n_latents: int = 32  # resampled conditioning rows
    max_prompt: int = 300


def init_perceiver(cfg: PerceiverConfig, generator: torch.Generator,
                   device) -> dict:
    """Random parameters at the JAX init's shapes and scales (the numbers
    come from ``generator``), float32."""
    def lin(d_in, d_out):
        return _init_linear(generator, d_in, d_out, torch.float32, device,
                            bias=True)

    def ones():
        return torch.ones((cfg.hidden,), device=device)

    def zeros():
        return torch.zeros((cfg.hidden,), device=device)

    p = {"latents": torch.randn((cfg.n_latents, cfg.hidden),
                                generator=generator, device=device) * 0.02,
         "in_proj": lin(cfg.in_dim, cfg.hidden), "layers": [],
         "norm_w": ones(), "norm_b": zeros()}
    for _ in range(cfg.layers):
        p["layers"].append({
            "nq_w": ones(), "nq_b": zeros(), "nk_w": ones(), "nk_b": zeros(),
            "q": lin(cfg.hidden, cfg.hidden),
            "kv": lin(cfg.hidden, 2 * cfg.hidden),
            "o": lin(cfg.hidden, cfg.hidden),
            "nf_w": ones(), "nf_b": zeros(),
            "ff1": lin(cfg.hidden, 4 * cfg.hidden),
            "ff2": lin(4 * cfg.hidden, cfg.hidden),
        })
    return p


def perceiver_resample(params: dict, cfg: PerceiverConfig,
                       feats: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """feats (B, T, in_dim), mask (B, T) bool -> latents (B, n_latents,
    hidden)."""
    B, T, _ = feats.shape
    x = linear(params["in_proj"], feats)
    lat = params["latents"][None].expand(B, -1, -1)
    hd = cfg.hidden // cfg.heads
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.bool, device=feats.device)
    kv_mask = torch.cat([mask, torch.ones((B, cfg.n_latents),
                                          dtype=torch.bool,
                                          device=feats.device)], dim=1)
    S = T + cfg.n_latents
    for lp in params["layers"]:
        q_in = layer_norm(lat, lp["nq_w"], lp["nq_b"])
        kv_in = layer_norm(torch.cat([x, lat], dim=1), lp["nk_w"],
                           lp["nk_b"])
        q = linear(lp["q"], q_in).reshape(B, cfg.n_latents, cfg.heads, hd)
        k, v = linear(lp["kv"], kv_in).chunk(2, dim=-1)
        k = k.reshape(B, S, cfg.heads, hd)
        v = v.reshape(B, S, cfg.heads, hd)
        s = torch.einsum("blhd,bshd->bhls", q, k) / math.sqrt(hd)
        s = torch.where(kv_mask[:, None, None, :], s,
                        torch.full_like(s, -1e30))
        a = torch.einsum("bhls,bshd->blhd", torch.softmax(s, -1), v)
        lat = lat + linear(lp["o"], a.reshape(B, cfg.n_latents, -1))
        h = layer_norm(lat, lp["nf_w"], lp["nf_b"])
        # jax.nn.gelu's default: the tanh approximation
        lat = lat + linear(lp["ff2"], F.gelu(linear(lp["ff1"], h),
                                             approximate="tanh"))
    return layer_norm(lat, params["norm_w"], params["norm_b"])
