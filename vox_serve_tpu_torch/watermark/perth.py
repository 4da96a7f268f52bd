"""The Perth (PerthNet implicit) watermarker, weight-compatible (port of
vox_serve_tpu/watermark/perth.py).

A 32 kHz STFT (periodic hann 2048, hop 320, centred with reflect padding),
the log-dB magnitude normalized against the 1e-9 floor with 15 dB of
headroom, a conv1d encoder over the subband up to 2 kHz (k1, five k7, k1
at 256 channels, leaky ReLU) gated by the loudness mask and added to that
subband, then the inverse STFT. Detection runs three decoders over the
subband stretched to 0.75x, 1x and 1.25x and weighs their marks by a
softmax of their attention outputs. ``load_perth_params`` maps the
published ``perth_net_250000.pth.tar`` (resemble-ai/Perth, key
``model``).

Serving audio (24 kHz) is resampled to 32 kHz, marked and resampled back by
``spectral.apply_watermark``. Everything the encode path reads is a device
tensor or made on the device by kernels, so it runs inside a captured CUDA
graph; ``torch.fft`` takes float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .spectral import hann, overlap_add, reflect_pad


@dataclasses.dataclass(frozen=True)
class PerthConfig:
    sample_rate: int = 32000
    n_fft: int = 2048
    hop: int = 320
    hidden: int = 256
    max_wmark_freq: float = 2000.0
    stft_magnitude_min: float = 1e-9
    headroom_db: float = 15.0

    @property
    def bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def subband(self) -> int:
        return int(round(self.bins * self.max_wmark_freq
                         / (self.sample_rate / 2)))

    @property
    def min_level_db(self) -> float:
        return 20.0 * math.log10(self.stft_magnitude_min)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
BRANCHES = ("slow", "normal", "fast")


def _conv_stack_names(prefix: str) -> list[str]:
    return [f"{prefix}.{i}.conv" for i in range(7)]


def load_perth_params(sd: dict, cfg: PerthConfig | None = None, *,
                      device="cpu") -> dict:
    """The PerthNet state dict (the checkpoint's ``model``) as float32
    tensors on ``device``; conv weights keep torch's (out, in, k)
    layout."""
    def conv(name):
        return {"w": torch.as_tensor(sd[name + ".weight"]).to(
                    device, torch.float32, copy=True),
                "b": torch.as_tensor(sd[name + ".bias"]).to(
                    device, torch.float32, copy=True)}

    params = {"encoder": [conv(n) for n in
                          _conv_stack_names("encoder.layers")]}
    for branch in BRANCHES:
        params[f"dec_{branch}"] = [
            conv(n) for n in _conv_stack_names(f"decoder.{branch}_layers")]
    return params


def init_perth_params(cfg: PerthConfig, generator: torch.Generator,
                      device) -> dict:
    """Random parameters at the JAX init's shapes and scales (the numbers
    come from ``generator``)."""
    def conv(cin, cout, k):
        return {"w": torch.randn((cout, cin, k), generator=generator,
                                 device=device) / math.sqrt(cin * k),
                "b": torch.zeros((cout,), device=device)}

    def stack(out_ch):
        s, h = cfg.subband, cfg.hidden
        return ([conv(s, h, 1)] + [conv(h, h, 7) for _ in range(5)]
                + [conv(h, out_ch, 1)])

    params = {"encoder": stack(cfg.subband)}
    for branch in BRANCHES:
        params[f"dec_{branch}"] = stack(2)
    return params


# ---------------------------------------------------------------------------
# the audio processor (torchaudio Spectrogram semantics: centred, reflect
# padding, periodic hann)
# ---------------------------------------------------------------------------
def perth_stft(cfg: PerthConfig, x: torch.Tensor):
    """x (B, S) float32 -> (normalized magnitude, phase), each (B, bins,
    F)."""
    n = cfg.n_fft
    window = hann(n, x.device)
    frames = reflect_pad(x, n // 2).unfold(-1, n, cfg.hop) * window
    spec = torch.fft.rfft(frames, dim=-1)                 # (B, F, bins)
    mag = 20.0 * torch.log10(torch.clamp(torch.abs(spec),
                                         min=cfg.stft_magnitude_min))
    mag = (mag - cfg.min_level_db) / (-cfg.min_level_db + cfg.headroom_db)
    return mag.transpose(1, 2), torch.angle(spec).transpose(1, 2)


def perth_istft(cfg: PerthConfig, mag_norm: torch.Tensor,
                phase: torch.Tensor, num_samples: int) -> torch.Tensor:
    n = cfg.n_fft
    mag_db = mag_norm * (-cfg.min_level_db + cfg.headroom_db) \
        + cfg.min_level_db
    mag = torch.pow(10.0, torch.clamp(mag_db / 20.0, max=10.0))
    comp = torch.complex(mag * torch.cos(phase),
                         mag * torch.sin(phase)).transpose(1, 2)
    frames = torch.fft.irfft(comp, n=n, dim=-1)           # (B, F, n)
    sig = overlap_add(frames, hann(n, mag.device), cfg.hop, 1e-11)
    return sig[:, n // 2:n // 2 + num_samples]


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def _stack(ps: list, x: torch.Tensor) -> torch.Tensor:
    for i, p in enumerate(ps):
        k = p["w"].shape[-1]
        x = F.conv1d(x, p["w"], p["b"], padding=(k - 1) // 2)
        if i < len(ps) - 1:
            x = F.leaky_relu(x, 0.01)
    return x


def _magmask(mag: torch.Tensor, p: float = 0.05) -> torch.Tensor:
    s = mag.sum(dim=1)                                    # (B, T)
    thresh = s.amax(dim=1, keepdim=True) * p
    return (s > thresh).to(torch.float32)[:, None]        # (B, 1, T)


def perth_encode_mag(params: dict, cfg: PerthConfig,
                     mag: torch.Tensor) -> torch.Tensor:
    """Watermark a normalized magnitude spectrogram (B, bins, T)."""
    sub = mag[:, :cfg.subband]
    res = _stack(params["encoder"], sub) * _magmask(mag)
    return torch.cat([sub + res, mag[:, cfg.subband:]], dim=1)


def _lerp(x: torch.Tensor, size: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=True) along the last
    axis, as the JAX package computes it (float32 positions)."""
    T = x.shape[-1]
    if size == T:
        return x
    pos = torch.linspace(0.0, T - 1, size, device=x.device)
    i0 = torch.floor(pos).long()
    i1 = torch.clamp(i0 + 1, max=T - 1)
    frac = pos - i0
    return x[..., i0] * (1 - frac) + x[..., i1] * frac


def _nerp(x: torch.Tensor, size: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') along the last axis."""
    T = x.shape[-1]
    idx = torch.floor(torch.arange(size, device=x.device,
                                   dtype=torch.float32) * (T / size)).long()
    return x[..., idx]


def perth_decode_mag(params: dict, cfg: PerthConfig,
                     mag: torch.Tensor) -> torch.Tensor:
    """(B, bins, T) -> (B,) watermark confidence."""
    mask = _magmask(mag)
    sub = mag[:, :cfg.subband]
    T = sub.shape[-1]
    attn, wm = [], []
    for name, size in (("slow", int(T * 1.25)), ("normal", T),
                       ("fast", int(T * 0.75))):
        out = _stack(params[f"dec_{name}"], _lerp(sub, size))  # (B, 2, S)
        m = _nerp(mask, out.shape[-1])
        msum = torch.clamp(m.sum(dim=2), min=1e-9)
        attn.append((out[:, :1] * m).sum(dim=2) / msum)         # (B, 1)
        wm.append((out[:, 1:] * m).sum(dim=2) / msum)
    a = torch.softmax(torch.cat(attn, dim=1), dim=1)             # (B, 3)
    return (torch.cat(wm, dim=1) * a).sum(dim=1)


def perth_encode_wav(params: dict, cfg: PerthConfig,
                     audio: torch.Tensor) -> torch.Tensor:
    """audio (B, S) float32 at ``cfg.sample_rate`` -> watermarked audio,
    same shape."""
    mag, phase = perth_stft(cfg, audio)
    return perth_istft(cfg, perth_encode_mag(params, cfg, mag), phase,
                       audio.shape[1])


def perth_get_watermark(params: dict, cfg: PerthConfig,
                        audio: torch.Tensor) -> torch.Tensor:
    mag, _ = perth_stft(cfg, audio)
    return torch.clamp(perth_decode_mag(params, cfg, mag), 0.0, 1.0)
