"""The Whisper log-mel front end (a copy of the two numpy functions of
vox_serve_tpu/encoders/whisper_exact.py that the port uses: the S3 v2
tokenizer's input features). The port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def slaney_mel_filters(n_mels: int, sr: int = 16000,
                       n_fft: int = 400) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels): the slaney scale and slaney
    area normalization. Returns (n_mels, n_fft // 2 + 1)."""
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sr / 2, n_bins)

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

    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def whisper_log_mel(audio: np.ndarray, n_mels: int = 128,
                    padding: int = 0) -> np.ndarray:
    """Whisper log-mel: hann 400 / hop 160 centered STFT, the final frame
    dropped, slaney mel, log10 floored 8 decades under the max, (x + 4) /
    4. audio (S,) -> (n_mels, F)."""
    x = np.asarray(audio, np.float32)
    if padding > 0:
        x = np.pad(x, (0, padding))
    n, hop = 400, 160
    window = np.hanning(n + 1)[:-1].astype(np.float32)
    xp = np.pad(x, (n // 2, n // 2), mode="reflect")
    F = (len(xp) - n) // hop + 1
    frames = np.lib.stride_tricks.sliding_window_view(xp, n)[::hop][:F]
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2  # (F, bins)
    spec = spec[:-1]  # the reference drops the last frame
    mel = slaney_mel_filters(n_mels) @ spec.T  # (n_mels, F-1)
    log_spec = np.log10(np.clip(mel, 1e-10, None))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
