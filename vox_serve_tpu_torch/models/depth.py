"""Depth ("code predictor") transformer over codebooks (port of
vox_serve_tpu/models/depth.py).

The depth "prefill" over [backbone hidden; embed(cb0)] and then one small
decode per codebook, with static shapes and no host reads, so that the
worker can capture it in its decode graphs. Its KV is a dense
``(L, B, max_seq, KH, D)`` tensor pair (max_seq = n_codebooks + 1 makes
paging pointless), updated in place. Around its four projections each
layer runs K6 on the card (``ops/kernels.py``, ``csrc/depth_layer.cu``)
and the kernels' plain versions on the CPU. The fused q|k|v and gate|up
projections are concatenated once (``prepare_depth_layers``), outside the
codebook loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.backbone import _init_linear, linear
from ..ops import kernels
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
    final-norm hidden (B, hidden).

    Around the four projections (plain ``x @ w``) a layer is four ops: the
    residual add with the norm after it, q/k norm with the rotary and the
    cache write, attention, SiLU. On the CPU they are the plain versions;
    on any other device K6's wrappers, which raise on a shape or type they
    refuse."""
    B, t, _ = x.shape
    if x.device.type == "cpu":
        add_norm, qkv_rope, attention, silu_mul = (
            kernels.depth_add_rms_norm_plain, kernels.depth_qkv_rope_plain,
            kernels.depth_attention_plain, kernels.depth_silu_mul_plain)
    else:
        add_norm, qkv_rope, attention, silu_mul = (
            kernels.depth_add_rms_norm, kernels.depth_qkv_rope,
            kernels.depth_attention, kernels.depth_silu_mul)

    layers = prepare_depth_layers(params)["layers"]
    h, r = x, None
    for li in range(cfg.num_layers):
        lp = tree_map(lambda a: a[li], layers)
        h, xin = add_norm(h, r, lp["input_norm"], cfg.rms_eps)
        qkv = (xin.reshape(B * t, -1) @ lp["w_qkv"]).reshape(B, t, -1)
        qn, kn = ((lp["attn"]["q_norm"], lp["attn"]["k_norm"])
                  if cfg.qk_norm else (None, None))
        q = qkv_rope(qkv, qn, kn, k_cache[li], v_cache[li], start_pos,
                     cfg.rope_theta, cfg.rms_eps)
        attn = attention(q, k_cache[li], v_cache[li], start_pos)
        o = linear(lp["attn"]["o"], attn.reshape(B * t, -1))
        h, xin = add_norm(h, o.reshape(B, t, -1), lp["post_norm"], cfg.rms_eps)
        gu = xin.reshape(B * t, -1) @ lp["w_gu"]
        r = linear(lp["mlp"]["down"], silu_mul(gu)).reshape(B, t, -1)
    _, h = add_norm(h, r, params["final_norm"], cfg.rms_eps)
    return h[:, -1]
