"""Audio watermarking in the detokenize step (port of
vox_serve_tpu/watermark/spectral.py).

A model with ``needs_watermarking`` has every decoded chunk marked before
its PCM leaves the device; the worker composes ``apply_watermark`` into its
detokenize graphs. Without the published SilentCipher / Perth weights, the
marker is the JAX package's dev spectral scheme: a message-keyed bipolar
pattern added to the STFT magnitude (256-point hann frames, hop 128),
scaled per frame by the frame's loudness and by a tiny content-adaptive
conv stack, then resynthesised by overlap-add; ``detect_watermark`` is its
correlation detector. These marks are non-standard (reference detectors do
not read them), and ``init_watermarker`` says so when it builds them.

Everything ``apply_watermark`` reads is a device tensor or made on the
device by kernels (the hann window, the frame views, the overlap-add), so
it runs inside a captured CUDA graph; ``torch.fft`` takes float32, so the
caller passes float32 audio. With SilentCipher parameters (``"sc"``, from
``watermark/silentcipher.py``) the chunk is resampled to the 44.1 kHz
model rate, embedded and resampled back. ``init_watermarker`` serves them
when a ``sony/silentcipher`` snapshot resolves (the 44.1 kHz checkpoint
and its ``hparams.yaml``, read with ``yaml`` when it can be imported, else
by a reader of its flat ``KEY: scalar`` lines); the Perth branch is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import get_logger

SILENTCIPHER_KEY = (11, 91, 60, 147, 209)


@dataclasses.dataclass(frozen=True)
class WatermarkConfig:
    style: str = "silentcipher"  # or "perth"
    n_fft: int = 256
    hop: int = 128
    strength: float = 0.015
    message: tuple[int, ...] = SILENTCIPHER_KEY
    message_bits: int = 40  # 5 bytes
    #: serving sample rate of the audio passed to apply_watermark
    sample_rate: int = 24000


def _message_pattern(cfg: WatermarkConfig, n_bins: int) -> np.ndarray:
    """Deterministic per-bin bipolar pattern derived from the message key
    (the JAX package's numbers, bit for bit)."""
    bits = []
    for byte in cfg.message:
        bits.extend((byte >> i) & 1 for i in range(8))
    rng = np.random.RandomState(
        sum(b << i for i, b in enumerate(bits)) % (2**31))
    pat = rng.randn(n_bins).astype(np.float32)
    pat -= pat.mean()  # zero-mean: clean audio correlates to ~0
    return pat / np.linalg.norm(pat)


def read_hparams(path) -> dict:
    """A SilentCipher ``hparams.yaml``: through ``yaml`` when it can be
    imported, else its top-level ``KEY: scalar`` lines (ints, floats,
    booleans, null, quoted or bare strings), which is all the loader
    reads."""
    text = open(path).read()
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        return yaml.safe_load(text) or {}
    out = {}
    for line in text.splitlines():
        line = line.split(" #", 1)[0].rstrip()
        if not line or line[0] in " \t-#" or ":" not in line:
            continue
        key, _, val = line.partition(":")
        out[key.strip()] = _scalar(val.strip())
    return out


def _scalar(v: str):
    if v in ("", "~", "null", "Null", "NULL"):
        return None
    if v in ("true", "True", "TRUE"):
        return True
    if v in ("false", "False", "FALSE"):
        return False
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _try_load_real_silentcipher(cfg: WatermarkConfig, device):
    """The published sony/silentcipher 44.1 kHz checkpoint when a snapshot
    resolves, as ``apply_watermark``'s ``"sc"`` parameters; else None."""
    try:
        from ..weights import resolve_model_dir

        model_dir = resolve_model_dir("sony/silentcipher")
        if model_dir is None:
            return None
        ckpt = model_dir / "44_1_khz" / "73999_iteration"
        if not (ckpt / "enc_c.ckpt").exists():
            return None
        from .silentcipher import (SilentCipherConfig,
                                   load_silentcipher_params,
                                   message_to_symbols)

        hp = read_hparams(ckpt / "hparams.yaml")
        sc_cfg = SilentCipherConfig(
            n_fft=hp.get("N_FFT", 1024), hop=hp.get("HOP_LENGTH", 512),
            sr=hp.get("SR", 44100),
            message_dim=hp.get("message_dim", 5),
            message_len=hp.get("message_len", 21),
            message_band_size=hp.get("message_band_size", 1024),
            message_sdr=hp.get("message_sdr", 36.0),
            frame_level_normalization=hp.get("frame_level_normalization",
                                             True))
        params = load_silentcipher_params(str(ckpt), sc_cfg, device=device)
        onehot = message_to_symbols(list(cfg.message), sc_cfg)
        return {"sc": params,
                "sc_msg": torch.from_numpy(onehot).to(device),
                "_sc_cfg": sc_cfg}
    except Exception as e:
        get_logger("watermark").warning(
            "silentcipher checkpoint load failed (%s)", type(e).__name__)
        return None


def init_watermarker(cfg: WatermarkConfig, generator: torch.Generator,
                     device) -> dict:
    """SilentCipher's published weights when a snapshot resolves (style
    "silentcipher"); otherwise the dev spectral marker's parameters on
    ``device``, with the JAX package's warning: the marks are
    non-standard."""
    if cfg.style == "silentcipher":
        real = _try_load_real_silentcipher(cfg, device)
        if real is not None:
            return real
    get_logger("watermark").warning(
        "published %s weights unavailable; serving with the NON-STANDARD dev "
        "spectral watermark — reference detectors will NOT read these marks",
        cfg.style)
    n_bins = cfg.n_fft // 2 + 1

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device) * 0.1

    return {
        # small conv stack shaping the embedding to the content
        "conv1": normal((16, 1, 5)),
        "conv2": normal((1, 16, 5)),
        "pattern": torch.from_numpy(_message_pattern(cfg, n_bins)).to(device),
    }


def watermark_kind(params: dict | None) -> str | None:
    """Which marker a parameter set serves: "silentcipher", "perth",
    "spectral", or None without parameters."""
    if params is None:
        return None
    if "sc" in params:
        return "silentcipher"
    if "perth" in params:
        return "perth"
    return "spectral"


def hann(n: int, device) -> torch.Tensor:
    """Periodic hann window, float32 (``np.hanning(n + 1)[:-1]``), made on
    the device."""
    return torch.hann_window(n, periodic=True, dtype=torch.float64,
                             device=device).float()


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., T) -> (..., T + 2 pad), numpy's "reflect" padding of the last
    axis (the JAX package's ``jnp.pad``), also where pad >= T, which
    ``F.pad`` refuses: the periodic extension of period 2 (T - 1), gathered
    by indices made on the device."""
    n = x.shape[-1]
    period = max(2 * (n - 1), 1)
    i = torch.remainder(torch.arange(-pad, n + pad, device=x.device), period)
    return x[..., torch.where(i >= n, period - i, i)]


def overlap_add(frames: torch.Tensor, window: torch.Tensor, hop: int,
                floor: float) -> torch.Tensor:
    """Windowed overlap-add of (B, F, n) frames, divided by the summed
    squared window where that exceeds ``floor``: (B, n + hop * (F - 1))."""
    B, Fr, n = frames.shape
    total = n + hop * (Fr - 1)

    def fold(x):  # (B', F, n) -> (B', total), overlapping frames summed
        return F.fold(x.transpose(1, 2), (1, total), (1, n),
                      stride=(1, hop))[:, 0, 0]

    sig = fold(frames * window)
    den = fold(torch.square(window).expand(1, Fr, n))
    return sig / torch.where(den > floor, den, torch.ones_like(den))


def _stft(x: torch.Tensor, n_fft: int, hop: int):
    window = hann(n_fft, x.device)
    frames = reflect_pad(x, n_fft // 2).unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, dim=-1), window


def _istft(spec: torch.Tensor, n_fft: int, hop: int, out_len: int,
           window: torch.Tensor) -> torch.Tensor:
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    sig = overlap_add(frames, window, hop, 1e-8)
    pad = n_fft // 2
    return sig[:, pad:pad + out_len]


def apply_watermark(params: dict, cfg: WatermarkConfig,
                    audio: torch.Tensor) -> torch.Tensor:
    """audio: (B, T) float32 in [-1, 1] -> watermarked audio, same shape."""
    if "sc" in params:
        # SilentCipher: resample to the 44.1 kHz model rate, embed,
        # resample back
        from .silentcipher import sc_encode, sinc_resample

        sc_cfg = params["_sc_cfg"]
        T = audio.shape[1]
        y = sinc_resample(audio, cfg.sample_rate, sc_cfg.sr)
        y = sc_encode(params["sc"], sc_cfg, y, params["sc_msg"])
        out = sinc_resample(y, sc_cfg.sr, cfg.sample_rate)
        if out.shape[1] < T:
            out = F.pad(out, (0, T - out.shape[1]))
        return out[:, :T]
    if "perth" in params:
        raise NotImplementedError(
            "the Perth watermark is not ported yet (it comes with the "
            "chatterbox model)")
    T = audio.shape[1]
    spec, window = _stft(audio, cfg.n_fft, cfg.hop)
    mag = torch.abs(spec)
    phase = torch.angle(spec)
    # content-adaptive gain from the tiny conv stack over per-frame loudness
    loud = torch.mean(mag, dim=-1)[:, None, :]            # (B, 1, F)
    g = torch.relu(F.conv1d(loud, params["conv1"], padding=2))
    g = F.conv1d(g, params["conv2"], padding=2)
    gain = torch.sigmoid(g)[:, 0, :, None]                # (B, F, 1)
    frame_level = torch.mean(mag, dim=-1, keepdim=True)   # (B, F, 1)
    wm = cfg.strength * gain * params["pattern"][None, None, :] * (
        frame_level + 1e-3)
    new_spec = torch.polar(torch.clamp(mag + wm, min=0.0), phase)
    out = _istft(new_spec, cfg.n_fft, cfg.hop, T, window)
    return torch.clamp(out, -1.0, 1.0)


def detect_watermark(params: dict, cfg: WatermarkConfig,
                     audio: torch.Tensor) -> torch.Tensor:
    """Correlation score (B,) of the message pattern in the audio: positive
    and well above the unwatermarked baseline when the mark is present."""
    spec, _ = _stft(audio, cfg.n_fft, cfg.hop)
    mag = torch.abs(spec)
    norm = mag / (torch.mean(mag, dim=-1, keepdim=True) + 1e-6)
    return torch.mean(torch.sum(norm * params["pattern"][None, None, :],
                                dim=-1), dim=-1)
