"""Depth ("code predictor") transformer over codebooks (port of
vox_serve_tpu/models/depth.py).

The depth "prefill" over [backbone hidden; embed(cb0)] and then one small
decode per codebook, with static shapes and no host reads, so that the
worker can capture it in its decode graphs. Its KV is a dense
``(L, B, max_seq, KH, D)`` tensor pair (max_seq = n_codebooks + 1 makes
paging pointless), updated in place; no kernel of its own. The fused
q|k|v and gate|up projections are concatenated once
(``prepare_depth_layers``), outside the codebook loop.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear
from ..ops.kernels import NEG_INF
from ..ops.norms import rms_norm
from ..ops.rope import rope_frequencies
from ..params import tree_map


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_seq: int            # n_codebooks + 1
    rms_eps: float = 1e-6
    qk_norm: bool = False
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16


def init_depth_params(cfg: DepthConfig, generator: torch.Generator,
                      device) -> dict:
    L, hd, Hs, dt = cfg.num_layers, cfg.head_dim, cfg.hidden_size, cfg.dtype

    def lin(d_in, d_out):
        return _init_linear(generator, d_in, d_out, dt, device, stack=L)

    attn = {
        "q": lin(Hs, cfg.num_heads * hd),
        "k": lin(Hs, cfg.num_kv_heads * hd),
        "v": lin(Hs, cfg.num_kv_heads * hd),
        "o": lin(cfg.num_heads * hd, Hs),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((L, hd), dtype=dt, device=device)
        attn["k_norm"] = torch.ones((L, hd), dtype=dt, device=device)
    return {
        "layers": {
            "attn": attn,
            "mlp": {
                "gate": lin(Hs, cfg.intermediate_size),
                "up": lin(Hs, cfg.intermediate_size),
                "down": lin(cfg.intermediate_size, Hs),
            },
            "input_norm": torch.ones((L, Hs), dtype=dt, device=device),
            "post_norm": torch.ones((L, Hs), dtype=dt, device=device),
        },
        "final_norm": torch.ones((Hs,), dtype=dt, device=device),
    }


def init_depth_kv(cfg: DepthConfig, batch: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.num_layers, batch, cfg.max_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def prepare_depth_layers(params: dict) -> dict:
    """Concatenate the fused q|k|v and gate|up projection weights once."""
    if "w_qkv" in params["layers"]:
        return params
    layers = dict(params["layers"])
    layers["w_qkv"] = torch.cat(
        [layers["attn"]["q"]["w"], layers["attn"]["k"]["w"],
         layers["attn"]["v"]["w"]], dim=2)
    layers["w_gu"] = torch.cat(
        [layers["mlp"]["gate"]["w"], layers["mlp"]["up"]["w"]], dim=2)
    return {"layers": layers, "final_norm": params["final_norm"]}


def depth_forward(params: dict, cfg: DepthConfig, x: torch.Tensor,
                  start_pos: int, k_cache: torch.Tensor,
                  v_cache: torch.Tensor) -> torch.Tensor:
    """Process t new tokens x: (B, t, hidden) at positions start_pos..;
    writes their K/V into the caches in place and returns the last token's
    final-norm hidden (B, hidden)."""
    B, t, _ = x.shape
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    S = cfg.max_seq
    inv_freq = rope_frequencies(hd, cfg.rope_theta, device=x.device)
    positions = torch.arange(start_pos, start_pos + t, device=x.device)
    angles = positions[:, None].float() * inv_freq[None, :]   # (t, hd/2)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    cache_pos = torch.arange(S, device=x.device)
    mask = cache_pos[None, :] <= positions[:, None]            # (t, S)
    scale = 1.0 / math.sqrt(hd)
    rep = H // KH

    def rot(v):
        v1, v2 = v[..., :hd // 2], v[..., hd // 2:]
        return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin],
                         dim=-1).to(v.dtype)

    layers = prepare_depth_layers(params)["layers"]
    h = x
    for li in range(cfg.num_layers):
        lp = tree_map(lambda a: a[li], layers)
        xin = rms_norm(h, lp["input_norm"], cfg.rms_eps)
        qkv = xin.reshape(B * t, -1) @ lp["w_qkv"]
        q, k, v = torch.split(qkv, [H * hd, KH * hd, KH * hd], dim=-1)
        q = q.reshape(B, t, H, hd)
        k = k.reshape(B, t, KH, hd)
        v = v.reshape(B, t, KH, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["attn"]["q_norm"], cfg.rms_eps)
            k = rms_norm(k, lp["attn"]["k_norm"], cfg.rms_eps)
        q = rot(q)
        k = rot(k)
        k_cache[li, :, start_pos:start_pos + t] = k.to(k_cache.dtype)
        v_cache[li, :, start_pos:start_pos + t] = v.to(v_cache.dtype)

        k_all = k_cache[li].float()  # (B, S, KH, D)
        v_all = v_cache[li].float()
        qg = q.reshape(B, t, KH, rep, hd).float() * scale
        scores = torch.einsum("btkrd,bskd->bkrts", qg, k_all)
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bkrts,bskd->btkrd", probs, v_all)
        attn = attn.reshape(B * t, H * hd).to(h.dtype)
        h = h + linear(lp["attn"]["o"], attn).reshape(B, t, -1)

        xin3 = rms_norm(h, lp["post_norm"], cfg.rms_eps)
        gu = xin3.reshape(B * t, -1) @ lp["w_gu"]
        g, u = torch.chunk(gu, 2, dim=-1)
        h = h + linear(lp["mlp"]["down"], F.silu(g) * u).reshape(B, t, -1)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return h[:, -1]
