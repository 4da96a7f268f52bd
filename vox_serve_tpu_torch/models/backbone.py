"""Config-driven decoder-only transformer backbone (port of
vox_serve_tpu/models/backbone.py).

Parameters are a plain dict of tensors in the JAX package's layout: layers
stacked on a leading axis, linear weights as ``(d_in, d_out)`` so that
``x @ w``. The layer loop is a Python loop (the JAX ``lax.scan``); the KV
pool(s) are updated in place per layer. Attention dispatches on the
tensor's device and the pool's layout and type (``ops/attention.py``): the
CPU runs the plain versions, the card the hand-written kernels, so there is
no ``use_pallas`` switch.

int8 weight-only quantization (``quantize_backbone_params``, the worker's
``weight_quant="int8"``) turns each q/k/v/o and gate/up/down leaf into
``{"w_q": int8 (d_in, d_out), "w_s": float32 (d_out,)}``, JAX's tree;
``pack_backbone_params`` then replaces each ``w_q`` by ``w_p``, K5's packed
layout (``ops/kernels.py`` ``pack_w8a16``), the tree ``backbone_forward``
runs. ``linear`` dispatches on the leaf's keys: a ``w_p`` leaf is K5 on
the card (``w8a16_linear``), and ``linear_group`` runs q/k/v and gate/up
as one K5 launch each, 4 launches a layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import (AttnMetadata, paged_attention_decode,
                             ragged_prefill_attention, write_kv_prefill)
from ..ops.kernels import (W8A16_K_TILE, W8A16Scratch, pack_w8a16,
                           w8a16_linear, w8a16_linear_group)
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import (apply_rope, apply_rope_interleaved,
                        rope_frequencies)
from ..parallel.sharding import shard_config
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
    #: ChatGLM's convention: rotate interleaved pairs (2i, 2i+1) instead of
    #: split halves (GLM-4-Voice)
    rope_interleaved: bool = False
    llama31_rope_scaling: bool = False  # Llama-3.1 frequency scaling
    rms_eps: float = 1e-6
    qkv_bias: bool = False  # Qwen2-style
    o_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False  # Qwen3-style per-head RMSNorm on q/k
    #: Zonos: LayerNorm with bias (at ``rms_eps``) for the input, post and
    #: final norms; the q/k norms stay RMSNorm
    use_layer_norm: bool = False
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
                 stack: Optional[int] = None, layerwise: bool = False
                 ) -> dict:
    """Normal(0, d_in^-1/2) weight (d_in, d_out), zero bias — the JAX
    init's shapes and scales. ``stack`` adds a leading layer axis;
    ``layerwise`` draws a stacked weight one layer at a time into its
    ``dtype`` tensor, so the float32 temporary is one layer's, not the
    stack's."""
    lead = () if stack is None else (stack,)
    if layerwise and stack is not None:
        w = torch.empty(lead + (d_in, d_out), dtype=dtype, device=device)
        if w.device.type != "meta":
            for i in range(stack):
                w[i].copy_(_randn((d_in, d_out), generator, device)
                           * (d_in ** -0.5))
    else:
        w = (_randn(lead + (d_in, d_out), generator, device)
             * (d_in ** -0.5)).to(dtype)
    p = {"w": w}
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


def linear(p: dict, x: torch.Tensor,
           scratch: Optional[W8A16Scratch] = None) -> torch.Tensor:
    """``x @ w (+ b)``; a packed int8 leaf (``w_p``, ``w_s``;
    ``pack_backbone_params``) takes JAX's rule instead, ``(x @
    w_q.astype(x.dtype)) * w_s.astype(x.dtype)`` (+ b), through K5
    (``scratch``: its split-K workspace)."""
    if "w_p" in p:
        return w8a16_linear(x, p["w_p"], p["w_s"], p.get("b"), scratch)
    x, w = promoted(x, p["w"])
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def linear_group(ps: list, x: torch.Tensor,
                 scratch: Optional[W8A16Scratch] = None) -> tuple:
    """``linear`` of each leaf of ``ps`` over the same x; packed leaves
    (all of them) as one K5 launch (``w8a16_linear_group``)."""
    if all("w_p" in p for p in ps):
        return w8a16_linear_group(
            x, [(p["w_p"], p["w_s"], p.get("b")) for p in ps], scratch)
    return tuple(linear(p, x, scratch) for p in ps)


def _quantize_weight(w: torch.Tensor, q: torch.Tensor,
                     s: torch.Tensor) -> None:
    """One (d_in, d_out) weight into ``q`` (int8) and ``s`` (float32
    (d_out,)), in JAX's arithmetic: float32, ``torch.round`` half to even
    as ``jnp.round``."""
    wf = w.float()
    s.copy_(torch.clamp_min(wf.abs().amax(dim=-2), 1e-8) / 127.0)
    q.copy_(torch.clamp(torch.round(wf / s[None, :]), -127, 127))


def quantize_linear_params(p: dict) -> dict:
    """Symmetric per-output-channel int8 quantization of a linear leaf
    {"w": (..., d_in, d_out)} -> {"w_q": int8, "w_s": float32 (...,
    d_out)}, the bias passed through (port of vox_serve_tpu's
    ``quantize_linear_params``, bit-equal). A stacked (L, d_in, d_out)
    weight is quantized one layer at a time, so the float32 temporary is
    one layer's (GLM-4-Voice's gate/up/down stack would be ~9 GB); the
    scales are per (layer, output channel), so the result is the same."""
    w = p["w"]
    lead, (d_in, d_out) = w.shape[:-2], w.shape[-2:]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(lead + (d_out,), dtype=torch.float32, device=w.device)
    wv = w.reshape(-1, d_in, d_out)
    qv, sv = q.view(-1, d_in, d_out), s.view(-1, d_out)
    for i in range(wv.shape[0]):
        _quantize_weight(wv[i], qv[i], sv[i])
    out = {"w_q": q, "w_s": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_backbone_params(params: dict) -> dict:
    """int8-quantize every matmul weight of a backbone tree (q/k/v/o,
    gate/up/down); norms, q/k norms and biases stay at full precision.
    The result feeds the same ``backbone_forward``: ``linear`` dispatches
    on the leaf keys. Untouched leaves are shared with ``params``."""
    out = dict(params)
    layers = dict(params["layers"])
    layers["attn"] = {
        k: (quantize_linear_params(v) if k in ("q", "k", "v", "o") else v)
        for k, v in params["layers"]["attn"].items()}
    layers["mlp"] = {k: quantize_linear_params(v)
                     for k, v in params["layers"]["mlp"].items()}
    out["layers"] = layers
    return out


#: the linears of a layer by K5 launch: q/k/v and gate/up share x
LINEAR_GROUPS = (("attn", ("q", "k", "v")), ("attn", ("o",)),
                 ("mlp", ("gate", "up")), ("mlp", ("down",)))


def pack_backbone_params(params: dict) -> dict:
    """Replace each quantized leaf's ``w_q`` (L, d_in, d_out) by ``w_p``,
    K5's packed layout (L, units, K tiles, 4096), one layer at a time
    (``pack_w8a16``); ``w_s``, biases and every other leaf are shared with
    ``params``."""
    out = dict(params)
    layers = dict(params["layers"])
    for part, names in LINEAR_GROUPS:
        sub = dict(layers[part])
        for name in names:
            leaf = dict(sub[name])
            leaf["w_p"] = pack_w8a16(leaf.pop("w_q"))
            sub[name] = leaf
        layers[part] = sub
    out["layers"] = layers
    return out


def w8a16_groups(params: dict) -> list[tuple[int, tuple[int, ...]]]:
    """The (padded K, output widths) of each K5 launch a layer of the
    packed tree makes (``W8A16Scratch``'s shapes)."""
    lay = params["layers"]
    return [(lay[part][names[0]]["w_p"].shape[-2] * W8A16_K_TILE,
             tuple(lay[part][n]["w_s"].shape[-1] for n in names))
            for part, names in LINEAR_GROUPS]


def init_backbone_params(cfg: BackboneConfig, generator: torch.Generator,
                         device, layerwise: bool = False) -> dict:
    """Random-init stacked params (layer axis leading) on ``device``;
    ``layerwise``: each weight drawn one layer at a time (``_init_linear``;
    GLM-4-Voice's 9B stack)."""
    hd = cfg.resolved_head_dim
    L, Hs, dt = cfg.num_layers, cfg.hidden_size, cfg.dtype

    def lin(d_in, d_out, bias=False):
        return _init_linear(generator, d_in, d_out, dt, device, bias=bias,
                            stack=L, layerwise=layerwise)

    attn = {
        "q": lin(Hs, cfg.num_heads * hd, cfg.qkv_bias),
        "k": lin(Hs, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "v": lin(Hs, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "o": lin(cfg.num_heads * hd, Hs, cfg.o_bias),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((L, hd), dtype=dt, device=device)
        attn["k_norm"] = torch.ones((L, hd), dtype=dt, device=device)
    mlp = {
        "gate": lin(Hs, cfg.intermediate_size, cfg.mlp_bias),
        "up": lin(Hs, cfg.intermediate_size, cfg.mlp_bias),
        "down": lin(cfg.intermediate_size, Hs, cfg.mlp_bias),
    }
    params = {
        "layers": {
            "attn": attn,
            "mlp": mlp,
            "input_norm": torch.ones((L, Hs), dtype=dt, device=device),
            "post_norm": torch.ones((L, Hs), dtype=dt, device=device),
        },
        "final_norm": torch.ones((Hs,), dtype=dt, device=device),
    }
    if cfg.use_layer_norm:
        for name in ("input_norm_b", "post_norm_b"):
            params["layers"][name] = torch.zeros((L, Hs), dtype=dt,
                                                 device=device)
        params["final_norm_b"] = torch.zeros((Hs,), dtype=dt, device=device)
    return params


def _norm(cfg: BackboneConfig, x: torch.Tensor, p: dict,
          name: str) -> torch.Tensor:
    """The block norm ``name`` of ``p``: RMSNorm, or LayerNorm with its
    ``name + "_b"`` bias under ``use_layer_norm``, both at ``rms_eps``."""
    if cfg.use_layer_norm:
        return layer_norm(x, p[name], p[name + "_b"], cfg.rms_eps)
    return rms_norm(x, p[name], cfg.rms_eps)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _row_linear(p: dict, x: torch.Tensor, ws: Optional[W8A16Scratch],
                split: bool) -> torch.Tensor:
    """A row-parallel linear (o, down): on a rank of a split backbone its
    partial sum without the bias, which ``_add_row_bias`` adds once after
    the reduce; whole, ``linear``."""
    if split and "b" in p:
        p = {k: v for k, v in p.items() if k != "b"}
    return linear(p, x, ws)


def _add_row_bias(p: dict, y: torch.Tensor, split: bool) -> torch.Tensor:
    return y + p["b"] if split and "b" in p else y


def backbone_layers(params: dict, cfg: BackboneConfig, x: torch.Tensor,
                    positions: torch.Tensor, meta: AttnMetadata,
                    k_pages: torch.Tensor,
                    v_pages: Optional[torch.Tensor] = None,
                    kv_scales: Optional[tuple[float, float]] = None,
                    split: bool = False):
    """The decoder stack as a generator: it yields each layer's output of
    o, then of down, and takes back their sums over the ranks (the tensor
    itself when the backbone is whole); it returns the final-norm hidden.
    ``split``: ``params`` and ``cfg`` are one rank's
    (``parallel/sharding.py``), so o and down yield partial sums and
    their biases wait for the sums."""
    hd = cfg.resolved_head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    inv_freq = rope_frequencies(cfg.rope_dim or hd, cfg.rope_theta,
                                device=x.device,
                                llama31_scaling=cfg.llama31_rope_scaling)
    rope = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    T = x.shape[0]
    h = x
    ws = meta.linear_scratch
    for li in range(cfg.num_layers):
        lp = tree_map(lambda a: a[li], params["layers"])  # views
        xin = _norm(cfg, h, lp, "input_norm")
        q, k, v = linear_group([lp["attn"][n] for n in "qkv"], xin, ws)
        q, k, v = (q.reshape(T, H, hd), k.reshape(T, KH, hd),
                   v.reshape(T, KH, hd))
        if cfg.qk_norm:
            q = rms_norm(q, lp["attn"]["q_norm"], cfg.rms_eps)
            k = rms_norm(k, lp["attn"]["k_norm"], cfg.rms_eps)
        q, k = rope(q, k, positions, inv_freq, rope_dim=cfg.rope_dim)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

        write_kv_prefill(k_pages, v_pages, li, k, v, meta, kv_scales)
        if meta.is_prefill:
            attn_out = ragged_prefill_attention(q, k, v, meta,
                                                scale=cfg.attn_scale)
        else:
            attn_out = paged_attention_decode(q, k_pages, v_pages, li, meta,
                                              scale=cfg.attn_scale,
                                              kv_scales=kv_scales)
        o = yield _row_linear(lp["attn"]["o"], attn_out.reshape(T, H * hd),
                              ws, split)
        h = h + _add_row_bias(lp["attn"]["o"], o, split)

        xin2 = _norm(cfg, h, lp, "post_norm")
        gate, up = linear_group([lp["mlp"]["gate"], lp["mlp"]["up"]], xin2,
                                ws)
        gated = F.silu(gate) * up
        d = yield _row_linear(lp["mlp"]["down"], gated, ws, split)
        h = h + _add_row_bias(lp["mlp"]["down"], d, split)
    return _norm(cfg, h, params, "final_norm")


def drive_layers(gens: list, reduce) -> list:
    """Run ``backbone_layers`` generators in lock step: at each of their
    yields, ``reduce`` takes the list of yielded tensors and gives back
    the list each generator receives. Returns their results."""
    outs = [next(g) for g in gens]
    while True:
        results, nxt = [], []
        for g, s in zip(gens, reduce(outs)):
            try:
                nxt.append(g.send(s))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            return results
        outs = nxt


def backbone_forward(params: dict, cfg: BackboneConfig, x: torch.Tensor,
                     positions: torch.Tensor, meta: AttnMetadata,
                     k_pages: torch.Tensor,
                     v_pages: Optional[torch.Tensor] = None,
                     kv_scales: Optional[tuple[float, float]] = None,
                     tp=None) -> torch.Tensor:
    """Run the decoder stack.

    x: (T, hidden) token embeddings; positions: (T,) absolute positions.
    k_pages, v_pages: the combined pool and None, or the legacy pair.
    kv_scales: static dequant multipliers when the pool is quantized
    (ops/kv_cache.py KVCacheConfig.kv_scales); None = full precision.
    Writes this step's K/V into the pool(s) in place. Prefill runs ragged
    causal attention over the packed buffer (K3 on the card, for every
    bucket size); decode runs paged attention over the pool (K1, K1q or K4
    on the card); a packed int8 tree's matmuls run K5 on the card, 4
    launches a layer, with ``meta.linear_scratch`` as its split-K
    workspace. Returns the final-norm hidden (T, hidden).

    ``tp`` (``parallel/ranks.py`` ``TPGroup``): this process is one rank
    of a tensor-parallel backbone. ``params`` and the pool are its shard,
    ``cfg`` the whole backbone's; x (in the backbone's dtype) comes from
    rank 0 by broadcast, and each layer all-reduces its o and down
    partial sums: two collectives a layer."""
    if tp is None:
        gens = [backbone_layers(params, cfg, x, positions, meta, k_pages,
                                v_pages, kv_scales)]
        return drive_layers(gens, lambda outs: outs)[0]
    cfg = shard_config(cfg, tp.size)
    x = tp.broadcast(x.to(cfg.dtype).contiguous())
    gens = [backbone_layers(params, cfg, x, positions, meta, k_pages,
                            v_pages, kv_scales, split=True)]
    return drive_layers(gens, lambda outs: [tp.all_reduce(outs[0])])[0]


def backbone_forward_shards(shards: list, cfg: BackboneConfig,
                            x: torch.Tensor, positions: torch.Tensor,
                            metas: list, pools: list,
                            kv_scales: Optional[tuple[float, float]] = None
                            ) -> torch.Tensor:
    """A tensor-parallel backbone's ranks run one after another on one
    device, the sum of their partial products in place of each
    all-reduce: ``shards`` (``shard_params``), ``metas`` and ``pools``
    (each a (k_pages, v_pages) pair) one per rank. Returns rank 0's final
    hidden, the one a served step reads."""
    lcfg = shard_config(cfg, len(shards))
    gens = [backbone_layers(p, lcfg, x, positions, m, *pool, kv_scales,
                            split=True)
            for p, m, pool in zip(shards, metas, pools)]

    def add(outs):
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return [total] * len(outs)
    return drive_layers(gens, add)[0]
