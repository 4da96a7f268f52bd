"""SNAC multi-scale neural audio codec, decode path (port of
vox_serve_tpu/codecs/snac.py).

Multi-rate residual VQ (``snac_from_codes``: per-codebook embedding -> 1x1
out_proj -> repeat by stride, summed) followed by a conv decoder: a
depthwise + pointwise stem, decoder blocks of [snake, ConvTranspose(2s, s),
three dilated residual units], snake, a 7-tap head and tanh. Weight-norm is
folded at load time, so every conv is plain. Decode is stateless: a
detokenize window carries no codec cache (Orpheus overlaps its windows
instead).

The parameter tree is the JAX package's (torch conv layouts, snake alphas
of shape (1, C, 1)), so ``params.tree_to_torch`` converts it leaf for leaf.
The NoiseBlock's weights are kept in the tree, but its term is not
computed: the JAX package serves with ``noise_rng=None``, which adds zero.
The convolutions run in ``F.conv1d`` / ``F.conv_transpose1d``, as the JAX
package runs them outside any Pallas kernel.

Default config = hubertsiuzdak/snac_24khz (Orpheus), which has no
attention window. As in the JAX package, a config with
``attn_window_size`` only shifts the checkpoint's module indices past the
windowed local MHA's slot; the attention itself is not computed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .layers import (conv1d, conv_transpose1d, fold_weight_norm, init_conv1d,
                     init_conv_transpose1d, snake)


@dataclasses.dataclass(frozen=True)
class SNACConfig:
    sampling_rate: int = 24000
    decoder_dim: int = 1024
    decoder_rates: tuple[int, ...] = (8, 8, 4, 2)
    latent_dim: int = 768  # encoder_dim 48 * 2**4
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: tuple[int, ...] = (4, 2, 1)
    noise: bool = True
    depthwise: bool = True
    attn_window_size: int | None = None  # None for snac_24khz

    @property
    def n_codebooks(self) -> int:
        return len(self.vq_strides)

    @property
    def hop_per_latent(self) -> int:
        return int(math.prod(self.decoder_rates))


def init_snac_decoder(cfg: SNACConfig, generator: torch.Generator,
                      device) -> dict:
    """Random decoder parameters at ``cfg``'s widths (the JAX init's shapes
    and scales; the numbers come from ``generator``)."""

    def conv(i, o, k, **kw):
        return init_conv1d(generator, i, o, k, device, **kw)

    params: dict = {"quantizers": []}
    for _ in cfg.vq_strides:
        codebook = torch.randn((cfg.codebook_size, cfg.codebook_dim),
                               generator=generator, device=device) * 0.02
        params["quantizers"].append({
            "codebook": codebook,
            "out_proj": conv(cfg.codebook_dim, cfg.latent_dim, 1),
        })

    ch = cfg.decoder_dim
    dec: dict = {}
    if cfg.depthwise:
        dec["stem_dw"] = conv(cfg.latent_dim, cfg.latent_dim, 7,
                              groups=cfg.latent_dim)
        dec["stem_pw"] = conv(cfg.latent_dim, ch, 1)
    else:
        dec["stem"] = conv(cfg.latent_dim, ch, 7)

    def ones(c):
        return torch.ones((1, c, 1), device=device)

    blocks = []
    for i, stride in enumerate(cfg.decoder_rates):
        in_dim = ch // (2 ** i)
        out_dim = ch // (2 ** (i + 1))
        groups = out_dim if cfg.depthwise else 1
        b = {"alpha_in": ones(in_dim),
             "up": init_conv_transpose1d(generator, in_dim, out_dim,
                                         2 * stride, device),
             "res": []}
        if cfg.noise:
            b["noise"] = conv(out_dim, out_dim, 1, bias=False)
        for _ in (1, 3, 9):
            b["res"].append({
                "alpha1": ones(out_dim),
                "conv1": conv(out_dim, out_dim, 7, groups=groups),
                "alpha2": ones(out_dim),
                "conv2": conv(out_dim, out_dim, 1),
            })
        blocks.append(b)
    dec["blocks"] = blocks
    out_dim = ch // (2 ** len(cfg.decoder_rates))
    dec["alpha_out"] = ones(out_dim)
    dec["head"] = conv(out_dim, 1, 7)
    params["decoder"] = dec
    return params


def load_snac_params(sd: dict, cfg: SNACConfig, prefix: str = "") -> dict:
    """Map the published SNAC checkpoint (hubertsiuzdak/snac_24khz layout)
    onto the decoder's parameter tree, folding weight-norm: numpy arrays in,
    float32 numpy arrays out (``params.tree_to_torch`` puts them on a
    device). Only the decode path (quantizer out_proj + decoder)."""

    def arr(name):
        return np.asarray(sd[prefix + name])

    def f32(a):
        return np.asarray(a, np.float32)

    def wn(name):
        if prefix + name + ".parametrizations.weight.original0" in sd:
            w = fold_weight_norm(
                arr(f"{name}.parametrizations.weight.original0"),
                arr(f"{name}.parametrizations.weight.original1"))
        elif prefix + name + ".weight_g" in sd:
            w = fold_weight_norm(arr(f"{name}.weight_g"),
                                 arr(f"{name}.weight_v"))
        else:
            w = arr(f"{name}.weight")
        p = {"w": f32(w)}
        if prefix + name + ".bias" in sd:
            p["b"] = f32(arr(f"{name}.bias"))
        return p

    params: dict = {"quantizers": []}
    for i in range(len(cfg.vq_strides)):
        params["quantizers"].append({
            "codebook": f32(arr(f"quantizer.quantizers.{i}.codebook.weight")),
            "out_proj": wn(f"quantizer.quantizers.{i}.out_proj"),
        })

    dec: dict = {}
    d = "decoder.model"
    if cfg.depthwise:
        dec["stem_dw"] = wn(f"{d}.0")
        dec["stem_pw"] = wn(f"{d}.1")
        base = 2
    else:
        dec["stem"] = wn(f"{d}.0")
        base = 1
    if cfg.attn_window_size:
        base += 1  # the local MHA's slot
    blocks = []
    for i in range(len(cfg.decoder_rates)):
        pre = f"{d}.{base + i}.block"
        b = {"alpha_in": f32(arr(f"{pre}.0.alpha")), "up": wn(f"{pre}.1"),
             "res": []}
        res_start = 2
        if cfg.noise:
            b["noise"] = wn(f"{pre}.2.linear")
            res_start = 3
        for j in range(3):
            rp = f"{pre}.{res_start + j}.block"
            b["res"].append({
                "alpha1": f32(arr(f"{rp}.0.alpha")),
                "conv1": wn(f"{rp}.1"),
                "alpha2": f32(arr(f"{rp}.2.alpha")),
                "conv2": wn(f"{rp}.3"),
            })
        blocks.append(b)
    dec["blocks"] = blocks
    n = base + len(cfg.decoder_rates)
    dec["alpha_out"] = f32(arr(f"{d}.{n}.alpha"))
    dec["head"] = wn(f"{d}.{n + 1}")
    params["decoder"] = dec
    return params


def load_dac_params(sd: dict, cfg: SNACConfig) -> dict:
    """Map an HF ``DacModel`` state dict (descript/dac_44khz) onto the same
    decode tree (plain convs, no depthwise stem, noise or attention):
    numpy arrays in, float32 numpy arrays out."""

    def f32(name):
        return np.asarray(sd[name], np.float32)

    def conv(name):
        p = {"w": f32(f"{name}.weight")}
        if name + ".bias" in sd:
            p["b"] = f32(f"{name}.bias")
        return p

    params: dict = {"quantizers": []}
    for i in range(len(cfg.vq_strides)):
        params["quantizers"].append({
            "codebook": f32(f"quantizer.quantizers.{i}.codebook.weight"),
            "out_proj": conv(f"quantizer.quantizers.{i}.out_proj"),
        })
    dec: dict = {"stem": conv("decoder.conv1"), "blocks": []}
    for i in range(len(cfg.decoder_rates)):
        pre = f"decoder.block.{i}"
        b = {"alpha_in": f32(f"{pre}.snake1.alpha"),
             "up": conv(f"{pre}.conv_t1"), "res": []}
        for j in (1, 2, 3):
            rp = f"{pre}.res_unit{j}"
            b["res"].append({
                "alpha1": f32(f"{rp}.snake1.alpha"),
                "conv1": conv(f"{rp}.conv1"),
                "alpha2": f32(f"{rp}.snake2.alpha"),
                "conv2": conv(f"{rp}.conv2"),
            })
        dec["blocks"].append(b)
    dec["alpha_out"] = f32("decoder.snake1.alpha")
    dec["head"] = conv("decoder.conv2")
    params["decoder"] = dec
    return params


def _residual_unit(p: dict, x: torch.Tensor, dilation: int,
                   groups: int) -> torch.Tensor:
    """snake -> 7-tap dilated conv (depthwise: groups = C) -> snake -> 1x1
    conv, plus the input."""
    pad = (7 - 1) * dilation // 2
    y = snake(x, p["alpha1"])
    y = conv1d(p["conv1"], y, padding=pad, dilation=dilation, groups=groups)
    y = snake(y, p["alpha2"])
    y = conv1d(p["conv2"], y)
    return x + y


def snac_from_codes(params: dict, cfg: SNACConfig,
                    codes: list[torch.Tensor]) -> torch.Tensor:
    """codes[i]: (B, T_i) int with T_i * stride_i == latent T. Returns z_q
    (B, latent_dim, T)."""
    z_q = None
    for i, stride in enumerate(cfg.vq_strides):
        q = params["quantizers"][i]
        emb = q["codebook"][codes[i].long()].transpose(1, 2)  # (B, D, T_i)
        z = conv1d(q["out_proj"], emb)
        if stride > 1:
            z = z.repeat_interleave(stride, dim=-1)
        z_q = z if z_q is None else z_q + z
    return z_q


def snac_decode(params: dict, cfg: SNACConfig,
                codes: list[torch.Tensor]) -> torch.Tensor:
    """codes -> waveform (B, 1, T_latent * prod(decoder_rates)) in [-1, 1]."""
    z = snac_from_codes(params, cfg, codes)
    dec = params["decoder"]
    if cfg.depthwise:
        x = conv1d(dec["stem_dw"], z, padding=3, groups=cfg.latent_dim)
        x = conv1d(dec["stem_pw"], x)
    else:
        x = conv1d(dec["stem"], z, padding=3)
    for b, stride in zip(dec["blocks"], cfg.decoder_rates):
        out_dim = b["up"]["w"].shape[1]
        groups = out_dim if cfg.depthwise else 1
        x = snake(x, b["alpha_in"])
        x = conv_transpose1d(b["up"], x, stride=stride,
                             padding=math.ceil(stride / 2),
                             output_padding=stride % 2)
        for unit, dilation in zip(b["res"], (1, 3, 9)):
            x = _residual_unit(unit, x, dilation, groups)
    x = snake(x, dec["alpha_out"])
    x = conv1d(dec["head"], x, padding=3)
    return torch.tanh(x)
