"""Qwen3-TTS-Tokenizer-12Hz decoder, streaming-first (port of
vox_serve_tpu/codecs/qwen3_codec.py).

Split residual VQ (1 semantic + 15 acoustic quantizers, codebook =
embedding_sum / cluster_usage) -> causal pre-conv -> 8-layer transformer
over a 72-token rolling KV ring with LayerScale -> 2x (trans-conv +
ConvNeXt) upsampling -> causal trans-conv decoder (rates 8, 5, 4, 3) with
SnakeBeta and dilated residual units -> waveform at 24 kHz, 1920 samples per
12.5 Hz frame. One layout, NCH; the residual units run as plain PyTorch ops
(the port of the JAX package's XLA chain) unless ``VOX_FUSED_RESUNIT=1``
routes each block whose chunk is longer than 54 samples through K2
(``ops/resunit.py``), as the JAX package routes it through its Pallas
stack.

Streaming state is a functional dict (per-slot batched by the worker):
causal convs carry their left context, trans-convs their last input sample,
attention a rolling W-slot KV window. ``qwen3_codec_decode`` is streaming
over ring-sized chunks, so ``decode_chunk`` over those chunks equals it.
``load_qwen3_codec_params`` maps the Qwen/Qwen3-TTS-Tokenizer-12Hz
checkpoint's decoder onto this tree (float32 on the model's device).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear, promoted
from ..ops.kernels import NEG_INF
from ..ops.norms import layer_norm, rms_norm
from ..ops.resunit import fused_resunit_stack, use_fused_resunit
from ..ops.rope import rope_frequencies
from ..weights import _stack, to_device
from .layers import (causal_conv, conv1d, conv_transpose1d, init_conv1d,
                     init_conv_transpose1d, rvq_decode)


@dataclasses.dataclass(frozen=True)
class Qwen3CodecConfig:
    codebook_dim: int = 512
    codebook_size: int = 2048
    latent_dim: int = 1024
    decoder_dim: int = 1536
    hidden_size: int = 512
    intermediate_size: int = 1024
    head_dim: int = 64
    num_heads: int = 16
    num_kv_heads: int = 16
    num_layers: int = 8
    num_quantizers: int = 16
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 72
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: tuple[int, ...] = (2, 2)
    layer_scale_init: float = 0.01
    vq_dim: int = 256  # codebook_dim // 2

    @property
    def samples_per_frame(self) -> int:
        return int(math.prod(self.upsample_rates)
                   * math.prod(self.upsampling_ratios))


# ---------------------------------------------------------------------------
# init (float32, same shapes and scales as the JAX init)
# ---------------------------------------------------------------------------


def init_qwen3_codec(cfg: Qwen3CodecConfig, generator: torch.Generator,
                     device) -> dict:
    f32 = torch.float32

    def ones(*s):
        return torch.ones(s, dtype=f32, device=device)

    def full(v, *s):
        return torch.full(s, v, dtype=f32, device=device)

    def lin(d_in, d_out, bias=False):
        return _init_linear(generator, d_in, d_out, f32, device, bias)

    def conv(i, o, k, **kw):
        return init_conv1d(generator, i, o, k, device, **kw)

    def tconv(i, o, k):
        return init_conv_transpose1d(generator, i, o, k, device)

    def vq_group(n_q):
        return {
            "embed_sum": torch.randn(
                (n_q, cfg.codebook_size, cfg.vq_dim), generator=generator,
                device=device, dtype=f32) * 0.02,
            "usage": ones(n_q, cfg.codebook_size),
            "out_proj": conv(cfg.vq_dim, cfg.codebook_dim, 1, bias=False),
        }

    params: dict = {
        "rvq_first": vq_group(1),
        "rvq_rest": vq_group(cfg.num_quantizers - 1),
        "pre_conv": conv(cfg.codebook_dim, cfg.latent_dim, 3),
    }
    H, hd, KH = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    hs = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_norm": ones(hs),
            "post_norm": ones(hs),
            "q": lin(hs, H * hd),
            "k": lin(hs, KH * hd),
            "v": lin(hs, KH * hd),
            "o": lin(H * hd, hs),
            "gate": lin(hs, cfg.intermediate_size),
            "up": lin(hs, cfg.intermediate_size),
            "down": lin(cfg.intermediate_size, hs),
            "ls_attn": full(cfg.layer_scale_init, hs),
            "ls_mlp": full(cfg.layer_scale_init, hs),
        })
    params["transformer"] = {
        "layers": layers,
        "norm": ones(hs),
        "input_proj": lin(cfg.latent_dim, hs, bias=True),
        "output_proj": lin(hs, cfg.latent_dim, bias=True),
    }
    ld = cfg.latent_dim
    params["upsample"] = [{
        "trans": tconv(ld, ld, factor),
        "convnext": {
            "dw": conv(ld, ld, 7, groups=ld),
            "norm_w": ones(ld),
            "norm_b": torch.zeros((ld,), dtype=f32, device=device),
            "pw1": lin(ld, 4 * ld, bias=True),
            "pw2": lin(4 * ld, ld, bias=True),
            "gamma": full(1e-6, ld),
        },
    } for factor in cfg.upsampling_ratios]

    dec: dict = {"conv0": conv(cfg.latent_dim, cfg.decoder_dim, 7)}
    blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        in_dim = cfg.decoder_dim // (2 ** i)
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        res = []
        for _ in (1, 3, 9):
            res.append({
                "alpha1": full(0.0, out_dim),
                "beta1": full(0.0, out_dim),
                "conv1": conv(out_dim, out_dim, 7),
                "alpha2": full(0.0, out_dim),
                "beta2": full(0.0, out_dim),
                "conv2": conv(out_dim, out_dim, 1),
            })
        blocks.append({
            "alpha": full(0.0, in_dim),
            "beta": full(0.0, in_dim),
            "trans": tconv(in_dim, out_dim, 2 * rate),
            "res": res,
        })
    dec["blocks"] = blocks
    out_dim = cfg.decoder_dim // (2 ** len(cfg.upsample_rates))
    dec["alpha_out"] = full(0.0, out_dim)
    dec["beta_out"] = full(0.0, out_dim)
    dec["head"] = conv(out_dim, 1, 7)
    params["decoder"] = dec
    return params


def load_qwen3_codec_params(sd: dict, cfg: Qwen3CodecConfig, *,
                            device) -> dict:
    """Map the Qwen/Qwen3-TTS-Tokenizer-12Hz decoder checkpoint (torch
    layouts: Linear (out, in), Conv1d (out, in/groups, k), ConvTranspose1d
    (in, out, k)) onto the decoder's tree, float32 on ``device``. Takes the
    decoder's own keys (``pre_transformer...``) or the full codec model's
    (``decoder.pre_transformer...``); encoder tensors are ignored."""
    if any(k.startswith("decoder.pre_transformer.") for k in sd):
        sd = {k[len("decoder."):]: v for k, v in sd.items()
              if k.startswith("decoder.")}

    def arr(name):
        return to_device(sd[name], device, torch.float32)

    def lin(prefix):
        p = {"w": to_device(sd[f"{prefix}.weight"], device, torch.float32,
                            transpose=True)}
        if f"{prefix}.bias" in sd:
            p["b"] = arr(f"{prefix}.bias")
        return p

    def conv(prefix):
        p = {"w": arr(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["b"] = arr(f"{prefix}.bias")
        return p

    def vq_group(prefix, n_q):
        cb = f"{prefix}.vq.layers.{{i}}._codebook"
        return {
            "embed_sum": _stack(sd, cb + ".embedding_sum", n_q, device,
                                dtype=torch.float32),
            "usage": _stack(sd, cb + ".cluster_usage", n_q, device,
                            dtype=torch.float32),
            "out_proj": {"w": arr(f"{prefix}.output_proj.weight")},
        }

    params: dict = {
        "rvq_first": vq_group("quantizer.rvq_first", 1),
        "rvq_rest": vq_group("quantizer.rvq_rest", cfg.num_quantizers - 1),
        "pre_conv": conv("pre_conv.conv"),
    }
    layers = []
    for i in range(cfg.num_layers):
        pre = f"pre_transformer.layers.{i}"
        layers.append({
            "input_norm": arr(f"{pre}.input_layernorm.weight"),
            "post_norm": arr(f"{pre}.post_attention_layernorm.weight"),
            "q": lin(f"{pre}.self_attn.q_proj"),
            "k": lin(f"{pre}.self_attn.k_proj"),
            "v": lin(f"{pre}.self_attn.v_proj"),
            "o": lin(f"{pre}.self_attn.o_proj"),
            "gate": lin(f"{pre}.mlp.gate_proj"),
            "up": lin(f"{pre}.mlp.up_proj"),
            "down": lin(f"{pre}.mlp.down_proj"),
            "ls_attn": arr(f"{pre}.self_attn_layer_scale.scale"),
            "ls_mlp": arr(f"{pre}.mlp_layer_scale.scale"),
        })
    params["transformer"] = {
        "layers": layers,
        "norm": arr("pre_transformer.norm.weight"),
        "input_proj": lin("pre_transformer.input_proj"),
        "output_proj": lin("pre_transformer.output_proj"),
    }
    params["upsample"] = [{
        "trans": conv(f"upsample.{i}.0.conv"),
        "convnext": {
            "dw": conv(f"upsample.{i}.1.dwconv.conv"),
            "norm_w": arr(f"upsample.{i}.1.norm.weight"),
            "norm_b": arr(f"upsample.{i}.1.norm.bias"),
            "pw1": lin(f"upsample.{i}.1.pwconv1"),
            "pw2": lin(f"upsample.{i}.1.pwconv2"),
            "gamma": arr(f"upsample.{i}.1.gamma"),
        },
    } for i in range(len(cfg.upsampling_ratios))]

    dec: dict = {"conv0": conv("decoder.0.conv")}
    blocks = []
    for i in range(len(cfg.upsample_rates)):
        pre = f"decoder.{i + 1}.block"
        blocks.append({
            "alpha": arr(f"{pre}.0.alpha"),
            "beta": arr(f"{pre}.0.beta"),
            "trans": conv(f"{pre}.1.conv"),
            "res": [{
                "alpha1": arr(f"{pre}.{j + 2}.act1.alpha"),
                "beta1": arr(f"{pre}.{j + 2}.act1.beta"),
                "conv1": conv(f"{pre}.{j + 2}.conv1.conv"),
                "alpha2": arr(f"{pre}.{j + 2}.act2.alpha"),
                "beta2": arr(f"{pre}.{j + 2}.act2.beta"),
                "conv2": conv(f"{pre}.{j + 2}.conv2.conv"),
            } for j in range(3)],
        })
    dec["blocks"] = blocks
    n_up = len(cfg.upsample_rates)
    dec["alpha_out"] = arr(f"decoder.{n_up + 1}.alpha")
    dec["beta_out"] = arr(f"decoder.{n_up + 1}.beta")
    dec["head"] = conv(f"decoder.{n_up + 2}.conv")
    params["decoder"] = dec
    return params


# ---------------------------------------------------------------------------
# streaming cache
# ---------------------------------------------------------------------------


def qwen3_codec_init_cache(cfg: Qwen3CodecConfig, batch: int,
                           device) -> dict:
    """Zero cache; every leaf has the batch axis leading (the worker
    gathers and scatters per-slot rows on axis 0)."""
    W, KH, hd, L = (cfg.sliding_window, cfg.num_kv_heads, cfg.head_dim,
                    cfg.num_layers)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {
        "pos": z(batch, dtype=torch.int32),
        "attn_k": z(batch, L, W, KH, hd),
        "attn_v": z(batch, L, W, KH, hd),
        "pre_conv": z(batch, cfg.codebook_dim, 2),
        "upsample": [{"trans": z(batch, cfg.latent_dim, 1),
                      "convnext_dw": z(batch, cfg.latent_dim, 6)}
                     for _ in cfg.upsampling_ratios],
        "dec_conv0": z(batch, cfg.latent_dim, 6),
        "dec_blocks": [],
    }
    for i, _ in enumerate(cfg.upsample_rates):
        in_dim = cfg.decoder_dim // (2 ** i)
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        cache["dec_blocks"].append({
            "trans": z(batch, in_dim, 1),
            "res": [z(batch, out_dim, 6 * dil) for dil in (1, 3, 9)],
        })
    final_in = cfg.decoder_dim // (2 ** len(cfg.upsample_rates))
    cache["head"] = z(batch, final_in, 6)
    return cache


# ---------------------------------------------------------------------------
# building blocks (each returns (y, new_cache); cache=None => full causal pad)
# ---------------------------------------------------------------------------


def _snake_beta(x, alpha, beta):
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.square(torch.sin(x * a))


def _causal_transconv(p, x, stride, kernel, cache):
    """CausalTransConvNet semantics: full mode trims (kernel - stride) from
    both sides; chunk mode prepends the last input sample and keeps
    [stride : stride + T*stride]."""
    if cache is None:
        y = conv_transpose1d(p, x, stride=stride)
        trim = kernel - stride
        if trim > 0:
            y = y[:, :, trim:y.shape[-1] - trim]
        return y, None
    xin = torch.cat([cache.to(x.dtype), x], dim=-1)
    y = conv_transpose1d(p, xin, stride=stride)
    T = x.shape[-1]
    y = y[:, :, stride:stride + T * stride]
    return y, x[:, :, -1:]


def _convnext_block(p, x, cache):
    residual = x
    y, new_cache = causal_conv(p["dw"], x, 6, cache, groups=x.shape[1])
    y = y.transpose(1, 2)
    y = layer_norm(y, p["norm_w"], p["norm_b"], eps=1e-6)
    y = linear(p["pw1"], y)
    y = F.gelu(y, approximate="none")
    y = linear(p["pw2"], y)
    y = p["gamma"] * y
    y = y.transpose(1, 2)
    return residual + y, new_cache


def _residual_unit(p, x, dilation, cache):
    res = x
    y = _snake_beta(x, p["alpha1"], p["beta1"])
    y, new_cache = causal_conv(p["conv1"], y, 6 * dilation, cache,
                               dilation=dilation)
    y = _snake_beta(y, p["alpha2"], p["beta2"])
    y = conv1d(p["conv2"], y)
    return res + y, new_cache


# ---------------------------------------------------------------------------
# RVQ decode
# ---------------------------------------------------------------------------


def qwen3_rvq_decode(params: dict, cfg: Qwen3CodecConfig,
                     codes: torch.Tensor) -> torch.Tensor:
    """(B, 16, T) -> (B, 512, T): semantic (cb 0) + acoustic (cb 1..15)."""
    sem = rvq_decode(params["rvq_first"], codes[:, :1])
    ac = rvq_decode(params["rvq_rest"], codes[:, 1:])
    return sem + ac


# ---------------------------------------------------------------------------
# sliding-window transformer
# ---------------------------------------------------------------------------


def _transformer(params: dict, cfg: Qwen3CodecConfig, x: torch.Tensor,
                 cache: dict | None):
    """x: (B, T, latent) -> (B, T, latent). Batch forward is plain causal;
    streaming attends over the whole W-slot ring (zero-filled slots
    included) with a buffer-causal mask only, updating the ring first."""
    tp = params["transformer"]
    B, T, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    dev = x.device
    inv_freq = rope_frequencies(hd, cfg.rope_theta, device=dev)

    h = linear(tp["input_proj"], x)
    if cache is None:
        pos = torch.arange(T, device=dev)[None].expand(B, T)
        p = torch.arange(T, device=dev)
        mask = (p[None, :] <= p[:, None])[None].expand(B, T, T)
    else:
        if T > W:
            raise ValueError(f"chunk of {T} tokens exceeds the {W}-slot "
                             "KV ring")
        pos = cache["pos"].long()[:, None] + torch.arange(T, device=dev)
        kv_j = torch.arange(W, device=dev)
        q_i = W - T + torch.arange(T, device=dev)
        mask = (kv_j[None, :] <= q_i[:, None])[None].expand(B, T, W)

    angles = pos[..., None].float() * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rope(q):
        q1, q2 = q[..., :hd // 2], q[..., hd // 2:]
        return torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)

    new_k, new_v = [], []
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    for li, lp in enumerate(tp["layers"]):
        xin = rms_norm(h, lp["input_norm"], cfg.rms_eps)
        q = rope(linear(lp["q"], xin).reshape(B, T, H, hd))
        k = rope(linear(lp["k"], xin).reshape(B, T, KH, hd))
        v = linear(lp["v"], xin).reshape(B, T, KH, hd)
        if cache is None:
            k_all, v_all = k, v
        else:
            # update-then-attend: ring = [old[T:], new] (W slots)
            k_all = torch.cat([cache["attn_k"][:, li], k], dim=1)[:, -W:]
            v_all = torch.cat([cache["attn_v"][:, li], v], dim=1)[:, -W:]
            new_k.append(k_all)
            new_v.append(v_all)
        k_r = k_all.repeat_interleave(rep, dim=2) if rep > 1 else k_all
        v_r = v_all.repeat_interleave(rep, dim=2) if rep > 1 else v_all
        scores = torch.einsum("bthd,bshd->bhts", *promoted(q * scale, k_r))
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd",
                            *promoted(probs, v_r)).reshape(B, T, H * hd)
        h = h + lp["ls_attn"] * linear(lp["o"], attn)
        xin2 = rms_norm(h, lp["post_norm"], cfg.rms_eps)
        mlp = linear(lp["down"], F.silu(linear(lp["gate"], xin2))
                     * linear(lp["up"], xin2))
        h = h + lp["ls_mlp"] * mlp

    h = rms_norm(h, tp["norm"], cfg.rms_eps)
    out = linear(tp["output_proj"], h)
    new_cache = None
    if cache is not None:
        new_cache = {"attn_k": torch.stack(new_k, dim=1),
                     "attn_v": torch.stack(new_v, dim=1),
                     "pos": cache["pos"] + T}
    return out, new_cache


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------


def _pipeline(params: dict, cfg: Qwen3CodecConfig, codes: torch.Tensor,
              cache: dict | None):
    def c(*path):
        if cache is None:
            return None
        node = cache
        for key in path:
            node = node[key]
        return node

    hidden = qwen3_rvq_decode(params, cfg, codes)  # (B, 512, T)
    hidden, pre_cache = causal_conv(params["pre_conv"], hidden, 2,
                                    c("pre_conv"))
    hidden, tr_cache = _transformer(params, cfg, hidden.transpose(1, 2),
                                    cache)
    hidden = hidden.transpose(1, 2)  # (B, latent, T)

    new_ups = []
    for i, (stage, factor) in enumerate(zip(params["upsample"],
                                            cfg.upsampling_ratios)):
        hidden, t_cache = _causal_transconv(stage["trans"], hidden, factor,
                                            factor, c("upsample", i, "trans"))
        hidden, d_cache = _convnext_block(stage["convnext"], hidden,
                                          c("upsample", i, "convnext_dw"))
        new_ups.append({"trans": t_cache, "convnext_dw": d_cache})

    dec = params["decoder"]
    wav, c0_cache = causal_conv(dec["conv0"], hidden, 6, c("dec_conv0"))
    new_blocks = []
    fused = use_fused_resunit()
    for i, (b, rate) in enumerate(zip(dec["blocks"], cfg.upsample_rates)):
        wav = _snake_beta(wav, b["alpha"], b["beta"])
        wav, t_cache = _causal_transconv(b["trans"], wav, rate, 2 * rate,
                                         c("dec_blocks", i, "trans"))
        if fused and wav.shape[-1] > 54:
            # K2 on the card (opt-in, as in the JAX package)
            wav, res_caches = fused_resunit_stack(
                wav, b["res"], c("dec_blocks", i, "res"))
        else:
            res_caches = []
            for j, dil in enumerate((1, 3, 9)):
                wav, rcache = _residual_unit(b["res"][j], wav, dil,
                                             c("dec_blocks", i, "res", j))
                res_caches.append(rcache)
        new_blocks.append({"trans": t_cache, "res": res_caches})
    wav = _snake_beta(wav, dec["alpha_out"], dec["beta_out"])
    wav, head_cache = causal_conv(dec["head"], wav, 6, c("head"))
    wav = torch.clamp(wav, -1.0, 1.0)

    new_cache = None
    if cache is not None:
        new_cache = {
            "pos": tr_cache["pos"],
            "attn_k": tr_cache["attn_k"],
            "attn_v": tr_cache["attn_v"],
            "pre_conv": pre_cache,
            "upsample": new_ups,
            "dec_conv0": c0_cache,
            "dec_blocks": new_blocks,
            "head": head_cache,
        }
    return wav, new_cache


def qwen3_codec_decode(params: dict, cfg: Qwen3CodecConfig,
                       codes: torch.Tensor) -> torch.Tensor:
    """Full decode: (B, 16, T) -> (B, 1, T * samples_per_frame), run as the
    streaming pipeline from a fresh cache in ring-sized chunks (the serving
    path)."""
    cache = qwen3_codec_init_cache(cfg, codes.shape[0], codes.device)
    W = cfg.sliding_window
    outs = []
    for s in range(0, codes.shape[-1], W):
        wav, cache = _pipeline(params, cfg, codes[:, :, s:s + W], cache)
        outs.append(wav)
    return torch.cat(outs, dim=-1)


def qwen3_codec_decode_chunk(params: dict, cfg: Qwen3CodecConfig,
                             codes: torch.Tensor, cache: dict):
    """Streaming decode of one chunk with a functional cache."""
    return _pipeline(params, cfg, codes, cache)
