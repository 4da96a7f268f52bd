"""The log-mel front end of the dev speaker encoder (port of
vox_serve_tpu/encoders/mel.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..watermark.spectral import hann, reflect_pad


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular filterbank."""
    fmax = cfg.fmax or cfg.sample_rate / 2
    n_bins = cfg.n_fft // 2 + 1
    freqs = np.linspace(0, cfg.sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin), _hz_to_mel(fmax),
                          cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((cfg.n_mels, n_bins), np.float32)
    for i in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig
                        ) -> torch.Tensor:
    """audio (B, T) float32 -> log-mel (B, n_mels, frames), Whisper-style
    dynamic range compression (over each row's whole spectrogram)."""
    n, hop = cfg.n_fft, cfg.hop
    frames = reflect_pad(audio.float(), n // 2).unfold(-1, n, hop) * hann(
        n, audio.device)
    spec = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2     # (B, F, bins)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(audio.device)
    mel = torch.einsum("mf,btf->bmt", fb, spec)
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    top = torch.amax(logmel, dim=(1, 2), keepdim=True)
    return (torch.maximum(logmel, top - 8.0) + 4.0) / 4.0
