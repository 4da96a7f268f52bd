"""The dev x-vector encoder (port of vox_serve_tpu/encoders/speaker.py): a
compact TDNN with attentive statistics pooling, from a seed. CosyVoice2
uses it for a voice clone when its snapshot has no CAMPPlus checkpoint."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..codecs.layers import conv1d, init_conv1d
from ..models.backbone import _init_linear, linear


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    n_mels: int = 80
    channels: int = 512
    layers: int = 3
    out_dim: int = 192  # the x-vector dim (CAMPPlus / ECAPA convention)


def init_speaker_encoder(cfg: SpeakerEncoderConfig,
                         generator: torch.Generator, device) -> dict:
    """Random parameters (the JAX init's shapes and scales; the numbers
    come from ``generator``), float32."""
    p: dict = {"blocks": []}
    in_ch = cfg.n_mels
    for _ in range(cfg.layers):
        p["blocks"].append({"conv": init_conv1d(generator, in_ch,
                                                cfg.channels, 3, device)})
        in_ch = cfg.channels
    p["asp_w"] = init_conv1d(generator, cfg.channels, 128, 1, device)
    p["asp_v"] = init_conv1d(generator, 128, cfg.channels, 1, device)
    p["out"] = _init_linear(generator, 2 * cfg.channels, cfg.out_dim,
                            torch.float32, device, bias=True)
    return p


def speaker_embed(params: dict, cfg: SpeakerEncoderConfig,
                  mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, T) -> x-vector (B, out_dim): TDNN layers at
    dilations 1, 2, 3, ..., then attentive statistics pooling."""
    x = mel
    for i, b in enumerate(params["blocks"]):
        dil = i + 1
        x = F.relu(conv1d(b["conv"], x, padding=dil, dilation=dil))
    att = torch.tanh(conv1d(params["asp_w"], x))
    att = torch.softmax(conv1d(params["asp_v"], att), dim=-1)  # (B, C, T)
    mean = torch.sum(x * att, dim=-1)
    var = torch.sum((x ** 2) * att, dim=-1) - mean ** 2
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    return linear(params["out"], torch.cat([mean, std], dim=-1))
