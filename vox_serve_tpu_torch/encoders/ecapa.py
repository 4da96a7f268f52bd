"""ECAPA-TDNN speaker encoder of the Qwen3-TTS Base (voice clone) variant
(port of vox_serve_tpu/encoders/ecapa.py).

The reference ``Qwen3TTSSpeakerEncoder``: a reflect-"same" TDNN stem, three
SE-Res2Net blocks (1x1 TDNN, a Res2Net of ``scale - 1`` dilated TDNNs,
1x1 TDNN, squeeze-excitation, residual), multi-layer feature aggregation
over the blocks' outputs, attentive statistics pooling and a 1x1 conv to
the talker's width. Plain PyTorch (``F.conv1d``): the JAX package computes
it outside any Pallas kernel. The mel front end (``qwen3_speaker_mel``:
n_fft 1024, hop 256, slaney mel, log clamp) and ``slaney_mel_filterbank``
stay numpy, copied. ``load_ecapa_params`` maps the checkpoint's
``speaker_encoder.*`` tensors onto the tree ``init_ecapa`` makes, float32
on the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..codecs.layers import conv1d, init_conv1d
from ..watermark.spectral import reflect_pad
from ..weights import to_device


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    mel_dim: int = 80           # 128 for the Base (voice-clone) variant
    enc_dim: int = 2048
    channels: tuple[int, ...] = (512, 512, 512, 512, 1536)
    kernel_sizes: tuple[int, ...] = (5, 3, 3, 3, 1)
    dilations: tuple[int, ...] = (1, 2, 3, 4, 1)
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128


def _reflect_same_conv(p, x, kernel, dilation=1):
    """torch Conv1d(padding="same", padding_mode="reflect") for odd
    kernels, with numpy's reflection where the pad reaches past the clip
    (``F.pad`` refuses a pad as long as the signal)."""
    pad = (kernel - 1) * dilation // 2
    if pad > 0:
        x = reflect_pad(x, pad)
    return conv1d(p, x, padding=0, dilation=dilation)


def _tdnn(p, x, kernel, dilation=1):
    return F.relu(_reflect_same_conv(p["conv"], x, kernel, dilation))


def _res2net(p, x, scale, kernel, dilation):
    parts = torch.chunk(x, scale, dim=1)
    outs = [parts[0]]
    prev = None
    for i in range(1, scale):
        inp = parts[i] if i == 1 else parts[i] + prev
        prev = _tdnn(p["blocks"][i - 1], inp, kernel, dilation)
        outs.append(prev)
    return torch.cat(outs, dim=1)


def _se_block(p, x):
    m = torch.mean(x, dim=2, keepdim=True)
    m = F.relu(conv1d(p["conv1"], m))
    m = torch.sigmoid(conv1d(p["conv2"], m))
    return x * m


def _asp(p, x, eps=1e-12):
    """Attentive statistics pooling -> (B, 2C)."""
    T = x.shape[2]
    mean = torch.mean(x, dim=2)
    std = torch.sqrt(torch.clamp(torch.mean(
        torch.square(x - mean[:, :, None]), dim=2), min=eps))
    ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, T),
                     std[:, :, None].expand(-1, -1, T)], dim=1)
    att = _tdnn(p["tdnn"], ctx, 1)
    att = torch.softmax(conv1d(p["conv"], torch.tanh(att)), dim=2)
    mean = torch.sum(att * x, dim=2)
    std = torch.sqrt(torch.clamp(torch.sum(
        att * torch.square(x - mean[:, :, None]), dim=2), min=eps))
    return torch.cat([mean, std], dim=1)


def init_ecapa(cfg: EcapaConfig, generator: torch.Generator,
               device) -> dict:
    """Random float32 params at ``cfg``'s widths (the JAX init's shapes and
    scales)."""
    g = generator

    def conv(cin, cout, k):
        return init_conv1d(g, cin, cout, k, device)

    def tdnn(cin, cout, k):
        return {"conv": conv(cin, cout, k)}

    blocks = [tdnn(cfg.mel_dim, cfg.channels[0], cfg.kernel_sizes[0])]
    for i in range(1, len(cfg.channels) - 1):
        cin, cout = cfg.channels[i - 1], cfg.channels[i]
        width = cout // cfg.res2net_scale
        blocks.append({
            "tdnn1": tdnn(cin, cout, 1),
            "res2net": {"blocks": [tdnn(width, width, cfg.kernel_sizes[i])
                                   for _ in range(cfg.res2net_scale - 1)]},
            "tdnn2": tdnn(cout, cout, 1),
            "se": {"conv1": conv(cout, cfg.se_channels, 1),
                   "conv2": conv(cfg.se_channels, cout, 1)},
        })
    C = cfg.channels[-1]
    return {
        "blocks": blocks,
        "mfa": tdnn(C, C, cfg.kernel_sizes[-1]),
        "asp": {"tdnn": tdnn(C * 3, cfg.attention_channels, 1),
                "conv": conv(cfg.attention_channels, C, 1)},
        "fc": conv(C * 2, cfg.enc_dim, 1),
    }


def ecapa_embed(params: dict, cfg: EcapaConfig,
                mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, mel_dim) -> speaker embedding (B, enc_dim). Block outputs
    1..N-1 are concatenated into the MFA input, as in the reference."""
    x = mel.transpose(1, 2)  # (B, mel_dim, T)
    x = _tdnn(params["blocks"][0], x, cfg.kernel_sizes[0], cfg.dilations[0])
    outs = [x]
    for i, bp in enumerate(params["blocks"][1:], start=1):
        residual = x
        x = _tdnn(bp["tdnn1"], x, 1)
        x = _res2net(bp["res2net"], x, cfg.res2net_scale,
                     cfg.kernel_sizes[i], cfg.dilations[i])
        x = _tdnn(bp["tdnn2"], x, 1)
        x = _se_block(bp["se"], x) + residual
        outs.append(x)
    x = torch.cat(outs[1:], dim=1)
    x = _tdnn(params["mfa"], x, cfg.kernel_sizes[-1], cfg.dilations[-1])
    pooled = _asp(params["asp"], x)                     # (B, 2C)
    return conv1d(params["fc"], pooled[:, :, None])[:, :, 0]


def load_ecapa_params(sd: dict, cfg: EcapaConfig, *, device) -> dict:
    """Map the reference speaker encoder's state dict (the checkpoint's
    ``speaker_encoder.*`` tensors, prefix stripped when present) onto
    ``init_ecapa``'s tree, float32 on ``device``."""
    if any(k.startswith("speaker_encoder.") for k in sd):
        sd = {k[len("speaker_encoder."):]: v for k, v in sd.items()
              if k.startswith("speaker_encoder.")}

    def conv(prefix):
        p = {"w": to_device(sd[f"{prefix}.weight"], device, torch.float32)}
        if f"{prefix}.bias" in sd:
            p["b"] = to_device(sd[f"{prefix}.bias"], device, torch.float32)
        return p

    def tdnn(prefix):
        return {"conv": conv(f"{prefix}.conv")}

    blocks = [tdnn("blocks.0")]
    for i in range(1, len(cfg.channels) - 1):
        pre = f"blocks.{i}"
        blocks.append({
            "tdnn1": tdnn(f"{pre}.tdnn1"),
            "res2net": {"blocks": [
                tdnn(f"{pre}.res2net_block.blocks.{j}")
                for j in range(cfg.res2net_scale - 1)]},
            "tdnn2": tdnn(f"{pre}.tdnn2"),
            "se": {"conv1": conv(f"{pre}.se_block.conv1"),
                   "conv2": conv(f"{pre}.se_block.conv2")},
        })
    return {
        "blocks": blocks,
        "mfa": tdnn("mfa"),
        "asp": {"tdnn": tdnn("asp.tdnn"), "conv": conv("asp.conv")},
        "fc": conv("fc"),
    }


# ---------------------------------------------------------------------------
# mel front end (numpy, the JAX package's functions)
# ---------------------------------------------------------------------------


def slaney_mel_filterbank(sr: int, n_fft: int, n_mels: int,
                          fmin: float = 0.0, fmax: float | None = None
                          ) -> np.ndarray:
    """librosa.filters.mel (slaney scale + slaney norm), numpy."""
    fmax = fmax or sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10)
                                             / min_log_hz) / logstep, mels)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        freqs)

    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sr / 2.0, n_freqs)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def qwen3_speaker_mel(audio: np.ndarray, n_mels: int,
                      sr: int = 24000) -> np.ndarray:
    """Waveform (S,) float -> (T, n_mels) log-mel, the reference front end
    (n_fft 1024, hop 256, win 1024, center=False, reflect pad
    (n_fft - hop) // 2, slaney mel, log clamp 1e-5)."""
    n_fft, hop, win = 1024, 256, 1024
    pad = (n_fft - hop) // 2
    y = np.pad(audio.astype(np.float32), (pad, pad), mode="reflect")
    window = np.hanning(win + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * window[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1))          # (T, n_fft/2+1)
    spec = np.sqrt(spec ** 2 + 1e-9)
    fb = slaney_mel_filterbank(sr, n_fft, n_mels, 0.0, 12000.0)
    mel = spec @ fb.T                                    # (T, n_mels)
    return np.log(np.clip(mel, 1e-5, None))
