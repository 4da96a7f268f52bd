"""Config-driven decoder-only transformer backbone (port of
vox_serve_tpu/models/backbone.py).

Parameters are a plain dict of tensors in the JAX package's layout: layers
stacked on a leading axis, linear weights as ``(d_in, d_out)`` so that
``x @ w``. The layer loop is a Python loop (the JAX ``lax.scan``); the KV
pool(s) are updated in place per layer. Attention dispatches on the
tensor's device and the pool's layout and type (``ops/attention.py``): the
CPU runs the plain versions, the card the hand-written kernels, so there is
no ``use_pallas`` switch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import (AttnMetadata, paged_attention_decode,
                             ragged_prefill_attention, write_kv_prefill)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..params import tree_map


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: Optional[int] = None  # default hidden_size // num_heads
    rope_theta: float = 10000.0
    rope_dim: Optional[int] = None  # partial rotary if < head_dim
    llama31_rope_scaling: bool = False  # Llama-3.1 frequency scaling
    rms_eps: float = 1e-6
    qk_norm: bool = False  # Qwen3-style per-head RMSNorm on q/k
    attn_scale: Optional[float] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.hidden_size // self.num_heads)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def seeded_generator(device, seed: int) -> torch.Generator:
    """A torch.Generator for initializing tensors on ``device``. Tensors on
    the meta device (shapes only) draw no numbers; their generator lives on
    the CPU."""
    dev = torch.device(device)
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    g.manual_seed(seed)
    return g


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _init_linear(generator: torch.Generator, d_in: int, d_out: int,
                 dtype: torch.dtype, device, bias: bool = False,
                 stack: Optional[int] = None) -> dict:
    """Normal(0, d_in^-1/2) weight (d_in, d_out), zero bias — the JAX
    init's shapes and scales. ``stack`` adds a leading layer axis."""
    lead = () if stack is None else (stack,)
    w = _randn(lead + (d_in, d_out), generator, device) * (d_in ** -0.5)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def promoted(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands at their promoted dtype, as JAX promotes mixed operands
    (in a bf16 codec, the float32 activations that follow its float32
    rope meet bf16 weights and values)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    x, w = promoted(x, p["w"])
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def init_backbone_params(cfg: BackboneConfig, generator: torch.Generator,
                         device) -> dict:
    """Random-init stacked params (layer axis leading) on ``device``."""
    hd = cfg.resolved_head_dim
    L, Hs, dt = cfg.num_layers, cfg.hidden_size, cfg.dtype

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
    mlp = {
        "gate": lin(Hs, cfg.intermediate_size),
        "up": lin(Hs, cfg.intermediate_size),
        "down": lin(cfg.intermediate_size, Hs),
    }
    return {
        "layers": {
            "attn": attn,
            "mlp": mlp,
            "input_norm": torch.ones((L, Hs), dtype=dt, device=device),
            "post_norm": torch.ones((L, Hs), dtype=dt, device=device),
        },
        "final_norm": torch.ones((Hs,), dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def backbone_forward(params: dict, cfg: BackboneConfig, x: torch.Tensor,
                     positions: torch.Tensor, meta: AttnMetadata,
                     k_pages: torch.Tensor,
                     v_pages: Optional[torch.Tensor] = None,
                     kv_scales: Optional[tuple[float, float]] = None
                     ) -> torch.Tensor:
    """Run the decoder stack.

    x: (T, hidden) token embeddings; positions: (T,) absolute positions.
    k_pages, v_pages: the combined pool and None, or the legacy pair.
    kv_scales: static dequant multipliers when the pool is quantized
    (ops/kv_cache.py KVCacheConfig.kv_scales); None = full precision.
    Writes this step's K/V into the pool(s) in place. Prefill runs ragged
    causal attention over the packed buffer (K3 on the card, for every
    bucket size); decode runs paged attention over the pool (K1, K1q or K4
    on the card). Returns the final-norm hidden (T, hidden)."""
    hd = cfg.resolved_head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    inv_freq = rope_frequencies(cfg.rope_dim or hd, cfg.rope_theta,
                                device=x.device,
                                llama31_scaling=cfg.llama31_rope_scaling)
    T = x.shape[0]
    h = x
    for li in range(cfg.num_layers):
        lp = tree_map(lambda a: a[li], params["layers"])  # views
        xin = rms_norm(h, lp["input_norm"], cfg.rms_eps)
        q = linear(lp["attn"]["q"], xin).reshape(T, H, hd)
        k = linear(lp["attn"]["k"], xin).reshape(T, KH, hd)
        v = linear(lp["attn"]["v"], xin).reshape(T, KH, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["attn"]["q_norm"], cfg.rms_eps)
            k = rms_norm(k, lp["attn"]["k_norm"], cfg.rms_eps)
        q, k = apply_rope(q, k, positions, inv_freq, rope_dim=cfg.rope_dim)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

        write_kv_prefill(k_pages, v_pages, li, k, v, meta, kv_scales)
        if meta.is_prefill:
            attn_out = ragged_prefill_attention(q, k, v, meta,
                                                scale=cfg.attn_scale)
        else:
            attn_out = paged_attention_decode(q, k_pages, v_pages, li, meta,
                                              scale=cfg.attn_scale,
                                              kv_scales=kv_scales)
        h = h + linear(lp["attn"]["o"], attn_out.reshape(T, H * hd))

        xin2 = rms_norm(h, lp["post_norm"], cfg.rms_eps)
        gated = F.silu(linear(lp["mlp"]["gate"], xin2)) * linear(
            lp["mlp"]["up"], xin2)
        h = h + linear(lp["mlp"]["down"], gated)
    return rms_norm(h, params["final_norm"], cfg.rms_eps)
