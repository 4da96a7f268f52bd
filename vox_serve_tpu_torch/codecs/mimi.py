"""Mimi codec (the Moshi family's), the codec of CSM-1B (port of
vox_serve_tpu/codecs/mimi.py).

Decode, in the HF ``MimiModel`` order:

    split RVQ (1 semantic + 31 acoustic codebooks, embed_sum / usage, a
    256 -> 512 output projection per group)
    -> depthwise causal trans-conv x2 upsample (k=4, s=2, groups=512)
    -> 8-layer transformer at 25 Hz (LayerNorm with bias, GELU fc1/fc2,
       LayerScale, rope, a 250-token sliding window), no final norm
    -> SEANet decoder (ELU + causal convs, trans-convs at rates 8, 6, 5, 4
       with one bottleneck residual unit each) -> 24 kHz, 1920 samples per
       12.5 Hz frame.

Streaming is position-exact: the cache keeps each row's position, how many
of its ring slots hold real keys, and a (B, layers, 250, KH, D) K/V ring;
masks come from those per-row positions, so a chunked decode equals the
whole one and nothing takes a shape from data (the worker replays it in
captured graphs). The encoder (audio -> codes: SEANet encoder, encoder
transformer, x2 downsample, nearest-centroid RVQ) tokenizes CSM's audio
context. Activations are NCH; the attention is plain PyTorch (the JAX
package's is plain einsum attention, not a Pallas kernel). The checkpoint
mappers ``load_mimi_params`` (decode path) and ``load_mimi_encoder_params``
map the HF ``MimiModel`` state dict, under a prefix (``codec_model.`` in
sesame/csm-1b, ``encoder.`` in the Qwen3-TTS tokenizer), onto these trees
in float32 on the model's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear, promoted
from ..ops.kernels import NEG_INF
from ..ops.norms import layer_norm
from ..ops.rope import rope_frequencies
from ..weights import _stack, to_device
from .layers import (causal_conv, conv1d, conv_transpose1d, init_conv1d,
                     init_conv_transpose1d, rvq_decode)


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    n_codebooks: int = 32
    codebook_size: int = 2048
    vq_dim: int = 256
    hidden_size: int = 512          # transformer width == quantizer output
    intermediate_size: int = 2048
    head_dim: int = 64
    num_heads: int = 8
    num_kv_heads: int = 8
    num_layers: int = 8
    sliding_window: int = 250
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    num_filters: int = 64
    upsample_ratios: tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3

    @property
    def seanet_in(self) -> int:
        return self.num_filters * (2 ** len(self.upsample_ratios))

    @property
    def frame_samples(self) -> int:
        return int(math.prod(self.upsample_ratios)) * 2  # x2 upsample first


# ---------------------------------------------------------------------------
# init (float32, the JAX init's shapes and scales)
# ---------------------------------------------------------------------------


def _init_transformer(cfg: MimiConfig, g: torch.Generator, device) -> dict:
    hs, f32 = cfg.hidden_size, torch.float32
    H, hd, KH = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads

    def lin(d_in, d_out):
        return _init_linear(g, d_in, d_out, f32, device)

    def full(v):
        return torch.full((hs,), v, dtype=f32, device=device)

    return {"layers": [{
        "ln1_w": full(1.0), "ln1_b": full(0.0),
        "ln2_w": full(1.0), "ln2_b": full(0.0),
        "q": lin(hs, H * hd), "k": lin(hs, KH * hd), "v": lin(hs, KH * hd),
        "o": lin(H * hd, hs),
        "fc1": lin(hs, cfg.intermediate_size),
        "fc2": lin(cfg.intermediate_size, hs),
        "ls_attn": full(0.01), "ls_mlp": full(0.01),
    } for _ in range(cfg.num_layers)]}


def _init_vq_group(cfg: MimiConfig, g: torch.Generator, device, n_q: int,
                   out_proj: bool) -> dict:
    p = {
        "embed_sum": torch.randn((n_q, cfg.codebook_size, cfg.vq_dim),
                                 generator=g, device=device) * 0.02,
        "usage": torch.ones((n_q, cfg.codebook_size), device=device),
    }
    if out_proj:
        p["out_proj"] = init_conv1d(g, cfg.vq_dim, cfg.hidden_size, 1,
                                    device, bias=False)
    return p


def init_mimi(cfg: MimiConfig, generator: torch.Generator, device) -> dict:
    """Decoder params (codes -> audio)."""
    g = generator
    dim = cfg.seanet_in
    blocks = []
    for i, ratio in enumerate(cfg.upsample_ratios):
        cin, out = dim // (2 ** i), dim // (2 ** (i + 1))
        blocks.append({
            "trans": init_conv_transpose1d(g, cin, out, 2 * ratio, device),
            "res_conv1": init_conv1d(g, out, out // 2,
                                     cfg.residual_kernel_size, device),
            "res_conv2": init_conv1d(g, out // 2, out, 1, device),
        })
    return {
        "rvq_first": _init_vq_group(cfg, g, device, 1, True),
        "rvq_rest": _init_vq_group(cfg, g, device, cfg.n_codebooks - 1,
                                   True),
        "transformer": _init_transformer(cfg, g, device),
        # depthwise x2 upsample (HF MimiConvTranspose1d groups=512, no bias)
        "upsample_trans": init_conv_transpose1d(
            g, cfg.hidden_size, cfg.hidden_size, 4, device,
            groups=cfg.hidden_size, bias=False),
        "dec_conv0": init_conv1d(g, cfg.hidden_size, dim, cfg.kernel_size,
                                 device),
        "blocks": blocks,
        "head": init_conv1d(g, dim // (2 ** len(cfg.upsample_ratios)), 1,
                            cfg.last_kernel_size, device),
    }


def init_mimi_encoder(cfg: MimiConfig, generator: torch.Generator,
                      device) -> dict:
    """Encoder params (audio -> codes): SEANet encoder, encoder transformer,
    x2 downsample, per-group RVQ input projections and codebooks."""
    g, f, hs = generator, cfg.num_filters, cfg.hidden_size
    blocks = []
    for j, _ratio in enumerate(reversed(cfg.upsample_ratios)):
        cin = f * (2 ** j)
        blocks.append({
            "res_conv1": init_conv1d(g, cin, cin // 2,
                                     cfg.residual_kernel_size, device),
            "res_conv2": init_conv1d(g, cin // 2, cin, 1, device),
            "down": init_conv1d(g, cin, 2 * cin, 2 * _ratio, device),
        })
    return {
        "enc_conv0": init_conv1d(g, 1, f, cfg.kernel_size, device),
        "enc_blocks": blocks,
        "enc_final": init_conv1d(g, cfg.seanet_in, hs, cfg.last_kernel_size,
                                 device),
        "enc_transformer": _init_transformer(cfg, g, device),
        "downsample": init_conv1d(g, hs, hs, 4, device, bias=False),
        "in_proj_first": init_conv1d(g, hs, cfg.vq_dim, 1, device,
                                     bias=False),
        "in_proj_rest": init_conv1d(g, hs, cfg.vq_dim, 1, device,
                                    bias=False),
        "rvq_first": _init_vq_group(cfg, g, device, 1, False),
        "rvq_rest": _init_vq_group(cfg, g, device, cfg.n_codebooks - 1,
                                   False),
    }


# ---------------------------------------------------------------------------
# checkpoint mappers (HF MimiModel state dict -> the trees above)
# ---------------------------------------------------------------------------


def _mapper(sd: dict, prefix: str, device):
    def arr(name):
        return to_device(sd[prefix + name], device, torch.float32)

    def lin(name):
        p = {"w": to_device(sd[prefix + name + ".weight"], device,
                            torch.float32, transpose=True)}
        if prefix + name + ".bias" in sd:
            p["b"] = arr(name + ".bias")
        return p

    def conv(name):
        p = {"w": arr(name + ".weight")}
        if prefix + name + ".bias" in sd:
            p["b"] = arr(name + ".bias")
        return p

    def codebooks(name, n_q):
        t = prefix + f"quantizer.{name}.layers.{{i}}.codebook"
        return {"embed_sum": _stack(sd, t + ".embed_sum", n_q, device,
                                    dtype=torch.float32),
                "usage": _stack(sd, t + ".cluster_usage", n_q, device,
                                dtype=torch.float32)}

    def transformer(name, n_layers):
        return {"layers": [{
            "ln1_w": arr(f"{pre}.input_layernorm.weight"),
            "ln1_b": arr(f"{pre}.input_layernorm.bias"),
            "ln2_w": arr(f"{pre}.post_attention_layernorm.weight"),
            "ln2_b": arr(f"{pre}.post_attention_layernorm.bias"),
            "q": lin(f"{pre}.self_attn.q_proj"),
            "k": lin(f"{pre}.self_attn.k_proj"),
            "v": lin(f"{pre}.self_attn.v_proj"),
            "o": lin(f"{pre}.self_attn.o_proj"),
            "fc1": lin(f"{pre}.mlp.fc1"),
            "fc2": lin(f"{pre}.mlp.fc2"),
            "ls_attn": arr(f"{pre}.self_attn_layer_scale.scale"),
            "ls_mlp": arr(f"{pre}.mlp_layer_scale.scale"),
        } for pre in (f"{name}.layers.{i}" for i in range(n_layers))]}

    return arr, conv, codebooks, transformer


_SEM, _AC = ("semantic_residual_vector_quantizer",
             "acoustic_residual_vector_quantizer")


def load_mimi_params(sd: dict, cfg: MimiConfig, prefix: str = "", *,
                     device) -> dict:
    """The decode path of an HF ``MimiModel`` state dict (optionally under
    ``prefix``) -> ``init_mimi``'s tree."""
    arr, conv, codebooks, transformer = _mapper(sd, prefix, device)
    n_up = len(cfg.upsample_ratios)
    return {
        "rvq_first": {**codebooks(_SEM, 1), "out_proj": {"w": arr(
            f"quantizer.{_SEM}.output_proj.weight")}},
        "rvq_rest": {**codebooks(_AC, cfg.n_codebooks - 1), "out_proj": {
            "w": arr(f"quantizer.{_AC}.output_proj.weight")}},
        "transformer": transformer("decoder_transformer", cfg.num_layers),
        "upsample_trans": conv("upsample.conv"),
        "dec_conv0": conv("decoder.layers.0.conv"),
        "blocks": [{
            "trans": conv(f"decoder.layers.{2 + 3 * i}.conv"),
            "res_conv1": conv(f"decoder.layers.{3 + 3 * i}.block.1.conv"),
            "res_conv2": conv(f"decoder.layers.{3 + 3 * i}.block.3.conv"),
        } for i in range(n_up)],
        "head": conv(f"decoder.layers.{2 + 3 * n_up}.conv"),
    }


def load_mimi_encoder_params(sd: dict, cfg: MimiConfig, prefix: str = "",
                             *, device) -> dict:
    """The encode path of an HF ``MimiModel`` state dict (optionally under
    ``prefix``) -> ``init_mimi_encoder``'s tree, with the quantizer's input
    projections and codebooks."""
    arr, conv, codebooks, transformer = _mapper(sd, prefix, device)
    n_up = len(cfg.upsample_ratios)
    return {
        "enc_conv0": conv("encoder.layers.0.conv"),
        "enc_blocks": [{
            "res_conv1": conv(f"encoder.layers.{1 + 3 * j}.block.1.conv"),
            "res_conv2": conv(f"encoder.layers.{1 + 3 * j}.block.3.conv"),
            "down": conv(f"encoder.layers.{3 + 3 * j}.conv"),
        } for j in range(n_up)],
        "enc_final": conv(f"encoder.layers.{2 + 3 * n_up}.conv"),
        "enc_transformer": transformer("encoder_transformer",
                                       cfg.num_layers),
        "downsample": conv("downsample.conv"),
        "in_proj_first": {"w": arr(f"quantizer.{_SEM}.input_proj.weight")},
        "in_proj_rest": {"w": arr(f"quantizer.{_AC}.input_proj.weight")},
        "rvq_first": codebooks(_SEM, 1),
        "rvq_rest": codebooks(_AC, cfg.n_codebooks - 1),
    }


# ---------------------------------------------------------------------------
# streaming cache
# ---------------------------------------------------------------------------


def mimi_init_cache(cfg: MimiConfig, batch: int, device) -> dict:
    """Zero cache, the batch axis leading on every leaf (the worker gathers
    and scatters per-slot rows on axis 0)."""
    W, L = cfg.sliding_window, cfg.num_layers

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    dim = cfg.seanet_in
    return {
        "pos": z(batch, dtype=torch.int32),
        "attn_len": z(batch, dtype=torch.int32),
        "attn_k": z(batch, L, W, cfg.num_kv_heads, cfg.head_dim),
        "attn_v": z(batch, L, W, cfg.num_kv_heads, cfg.head_dim),
        "up_trans": z(batch, cfg.hidden_size, 1),
        "dec_conv0": z(batch, cfg.hidden_size, cfg.kernel_size - 1),
        "blocks": [{"trans": z(batch, dim // (2 ** i), 1),
                    "res": z(batch, dim // (2 ** (i + 1)),
                             cfg.residual_kernel_size - 1)}
                   for i in range(len(cfg.upsample_ratios))],
        "head": z(batch, dim // (2 ** len(cfg.upsample_ratios)),
                  cfg.last_kernel_size - 1),
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _causal_transconv(p, x, stride, cache, groups=1):
    """HF MimiConvTranspose1d causal semantics (all k - s padding trimmed
    on the right). Both modes prepend the previous input sample (zero
    without a cache) and keep outputs [stride : stride + T*stride]: a zero
    sample contributes nothing at those taps, so the two agree."""
    own = cache is None
    if own:
        cache = torch.zeros_like(x[:, :, :1])
    xin = torch.cat([cache.to(x.dtype), x], dim=-1)
    y = conv_transpose1d(p, xin, stride=stride, groups=groups)
    T = x.shape[-1]
    return y[:, :, stride:stride + T * stride], (None if own
                                                 else x[:, :, -1:])


def _mimi_transformer(layers: list, cfg: MimiConfig, x: torch.Tensor,
                      cache: dict | None):
    """x: (B, T, hidden). Position-exact sliding-window attention: a
    streamed chunk attends over the ring's W slots and its own T tokens,
    masking slots no real key has reached yet, so chunked == whole."""
    B, T, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    dev = x.device
    inv_freq = rope_frequencies(hd, cfg.rope_theta, device=dev)
    ar = torch.arange(T, dtype=torch.int32, device=dev)

    if cache is None:
        pos = ar[None].expand(B, T)
        mask = ((ar[None, :] <= ar[:, None])
                & (ar[None, :] > ar[:, None] - W))[None].expand(B, T, T)
    else:
        offset = cache["pos"]                                 # (B,)
        pos = offset[:, None] + ar
        kpos = torch.cat([offset[:, None] - W + torch.arange(
            W, dtype=torch.int32, device=dev)[None], pos], dim=1)  # (B, W+T)
        valid = kpos >= (offset - torch.clamp(cache["attn_len"],
                                              max=W))[:, None]
        qpos = pos[:, :, None]
        mask = ((kpos[:, None, :] <= qpos) & (kpos[:, None, :] > qpos - W)
                & valid[:, None, :])                          # (B, T, W+T)

    angles = pos[..., None].float() * inv_freq[None, None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rope(q):
        q1, q2 = q[..., :hd // 2], q[..., hd // 2:]
        return torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)

    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    h = x
    new_k, new_v = [], []
    for li, lp in enumerate(layers):
        xin = layer_norm(h, lp["ln1_w"], lp["ln1_b"], eps=cfg.norm_eps)
        q = rope(linear(lp["q"], xin).reshape(B, T, H, hd))
        k = rope(linear(lp["k"], xin).reshape(B, T, KH, hd))
        v = linear(lp["v"], xin).reshape(B, T, KH, hd)
        if cache is None:
            k_all, v_all = k, v
        else:
            k_all = torch.cat(promoted(cache["attn_k"][:, li], k), dim=1)
            v_all = torch.cat(promoted(cache["attn_v"][:, li], v), dim=1)
            new_k.append(k_all[:, -W:])
            new_v.append(v_all[:, -W:])
        k_r = k_all.repeat_interleave(rep, dim=2) if rep > 1 else k_all
        v_r = v_all.repeat_interleave(rep, dim=2) if rep > 1 else v_all
        scores = torch.einsum("bthd,bshd->bhts", *promoted(q * scale, k_r))
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd",
                            *promoted(probs, v_r)).reshape(B, T, H * hd)
        h = h + lp["ls_attn"] * linear(lp["o"], attn)
        xin2 = layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps=cfg.norm_eps)
        mlp = linear(lp["fc2"], F.gelu(linear(lp["fc1"], xin2),
                                       approximate="none"))
        h = h + lp["ls_mlp"] * mlp

    if cache is None:
        return h, None
    return h, {"attn_k": torch.stack(new_k, dim=1),
               "attn_v": torch.stack(new_v, dim=1),
               "pos": cache["pos"] + T,
               "attn_len": torch.clamp(cache["attn_len"] + T, max=W)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def mimi_decode_chunk(params: dict, cfg: MimiConfig, codes: torch.Tensor,
                      cache: dict | None):
    """codes (B, 32, T) -> (waveform (B, 1, T * 1920), new cache); a None
    cache decodes the chunk whole from silence and returns None."""
    def c(key):
        return None if cache is None else cache[key]

    z = (rvq_decode(params["rvq_first"], codes[:, :1])
         + rvq_decode(params["rvq_rest"], codes[:, 1:]))      # (B, 512, T)
    # x2 depthwise upsample (12.5 Hz -> 25 Hz)
    h, up_cache = _causal_transconv(params["upsample_trans"], z, 2,
                                    c("up_trans"), groups=cfg.hidden_size)
    h, tr_cache = _mimi_transformer(params["transformer"]["layers"], cfg,
                                    h.transpose(1, 2), cache)
    x = h.transpose(1, 2)                                     # (B, 512, 2T)
    x, c0 = causal_conv(params["dec_conv0"], x, cfg.kernel_size - 1,
                        c("dec_conv0"))
    new_blocks = []
    for i, (b, ratio) in enumerate(zip(params["blocks"],
                                       cfg.upsample_ratios)):
        bc = None if cache is None else cache["blocks"][i]
        x = F.elu(x)
        x, t_cache = _causal_transconv(b["trans"], x, ratio,
                                       None if bc is None else bc["trans"])
        r = F.elu(x)
        r, rc = causal_conv(b["res_conv1"], r, cfg.residual_kernel_size - 1,
                            None if bc is None else bc["res"])
        r = conv1d(b["res_conv2"], F.elu(r))
        x = x + r
        new_blocks.append({"trans": t_cache, "res": rc})
    wav, head_cache = causal_conv(params["head"], F.elu(x),
                                  cfg.last_kernel_size - 1, c("head"))
    if cache is None:
        return wav, None
    return wav, {**tr_cache, "up_trans": up_cache, "dec_conv0": c0,
                 "blocks": new_blocks, "head": head_cache}


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _enc_causal_conv(p, x, kernel, stride=1, dilation=1):
    """HF MimiConv1d causal padding: k_eff - stride on the left, plus what
    makes the last frame whole on the right."""
    k_eff = (kernel - 1) * dilation + 1
    pad_total = k_eff - stride
    length = x.shape[-1]
    n_frames = (length - k_eff + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_total)
    extra = int(ideal - length)
    return conv1d(p, F.pad(x, (pad_total, max(extra, 0))), stride=stride,
                  dilation=dilation)


def _rvq_encode(group: dict, z: torch.Tensor) -> torch.Tensor:
    """z (B, T, vq) -> codes (B, n_q, T) by residual nearest centroid."""
    embed = group["embed_sum"] / torch.clamp(group["usage"],
                                             min=1e-5)[..., None]
    codes = []
    residual = z
    for e in embed:                                       # (bins, vq)
        d = (torch.sum(residual * residual, -1, keepdim=True)
             - 2.0 * residual @ e.T
             + torch.sum(e * e, -1)[None, None, :])
        idx = torch.argmin(d, dim=-1)                     # (B, T)
        residual = residual - e[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1).to(torch.int32)


def mimi_encode(enc_params: dict, dec_params: dict | None, cfg: MimiConfig,
                audio: torch.Tensor) -> torch.Tensor:
    """audio (B, S) float -> codes (B, n_codebooks, T) at 12.5 Hz, in the
    HF order: SEANet encoder -> encoder transformer -> x2 downsample ->
    split RVQ encode. The codebooks come from enc_params when it has them,
    else from the decoder's params (plain Mimi shares them)."""
    vq = enc_params if "rvq_first" in enc_params else dec_params
    x = _enc_causal_conv(enc_params["enc_conv0"], audio[:, None, :],
                         cfg.kernel_size)
    for j, ratio in enumerate(reversed(cfg.upsample_ratios)):
        b = enc_params["enc_blocks"][j]
        r = _enc_causal_conv(b["res_conv1"], F.elu(x),
                             cfg.residual_kernel_size)
        x = x + conv1d(b["res_conv2"], F.elu(r))
        x = _enc_causal_conv(b["down"], F.elu(x), 2 * ratio, stride=ratio)
    x = _enc_causal_conv(enc_params["enc_final"], F.elu(x),
                         cfg.last_kernel_size)
    h, _ = _mimi_transformer(enc_params["enc_transformer"]["layers"], cfg,
                             x.transpose(1, 2), None)
    x = _enc_causal_conv(enc_params["downsample"], h.transpose(1, 2), 4,
                         stride=2)
    z_sem = conv1d(enc_params["in_proj_first"], x).transpose(1, 2)
    z_ac = conv1d(enc_params["in_proj_rest"], x).transpose(1, 2)
    return torch.cat([_rvq_encode(vq["rvq_first"], z_sem),
                      _rvq_encode(vq["rvq_rest"], z_ac)], dim=1)
