"""Logging and small host-side utilities of the port.

A copy of what the port uses of vox_serve_tpu/utils.py: the logger factory
with a process-global, thread-safe log level, the rank-prefixing adapter,
``cdiv`` and the WAV reader ``load_audio_mono``. The port keeps its own
copy so that it imports nothing of the JAX package; the loggers are named
``vox_serve_tpu_torch.<name>``.
"""

from __future__ import annotations

import logging
import sys
import threading

_LEVEL_LOCK = threading.Lock()
_GLOBAL_LEVEL = logging.INFO
_LOGGERS: dict[str, logging.Logger] = {}

_FMT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def set_global_log_level(level: str | int) -> None:
    """Set the level for all of the port's loggers (thread-safe)."""
    global _GLOBAL_LEVEL
    if isinstance(level, str):
        resolved = getattr(logging, level.upper(), None)
        if not isinstance(resolved, int):
            raise ValueError(
                f"unknown log level {level!r}; expected one of "
                "DEBUG/INFO/WARNING/ERROR/CRITICAL")
        level = resolved
    with _LEVEL_LOCK:
        _GLOBAL_LEVEL = level
        for lg in _LOGGERS.values():
            lg.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    """Logger factory; all loggers share the global level."""
    with _LEVEL_LOCK:
        if name in _LOGGERS:
            return _LOGGERS[name]
        lg = logging.getLogger(f"vox_serve_tpu_torch.{name}")
        lg.setLevel(_GLOBAL_LEVEL)
        if not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(_FMT))
            lg.addHandler(h)
        lg.propagate = False
        _LOGGERS[name] = lg
        return lg


class RankLogger(logging.LoggerAdapter):
    """Prefixes messages with a data-parallel rank."""

    def __init__(self, logger: logging.Logger, rank: int | None):
        super().__init__(logger, {})
        self.rank = rank

    def process(self, msg, kwargs):
        if self.rank is None:
            return msg, kwargs
        return f"[dp rank {self.rank}] {msg}", kwargs


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def load_audio_mono(path: str, target_sr: "int | None",
                    return_sr: bool = False):
    """Read a PCM WAV file -> mono float32 in [-1, 1] at target_sr (stdlib
    ``wave`` and a linear resample, as the JAX package reads reference
    audio)."""
    import wave

    import numpy as np

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if target_sr is not None and sr != target_sr and len(x):
        t_out = np.linspace(0.0, len(x) - 1.0,
                            int(round(len(x) * target_sr / sr)))
        x = np.interp(t_out, np.arange(len(x)), x).astype(np.float32)
        sr = target_sr
    return (x, sr) if return_sr else x
