"""SilentCipher watermark embedder (sony/silentcipher), weight-compatible
math (port of vox_serve_tpu/watermark/silentcipher.py).

The encode path of the published 44.1 kHz model: a gated-conv2d carrier
encoder (1 -> 32 channels), the message linear over the symbol axis, the
carrier decoder (96-channel gated convs -> a residual magnitude), hann
1024/512 STFT / ISTFT, VCTK power normalization and SDR scaling; the
message decoder reads the symbols back for round-trip tests. 24 kHz
serving audio reaches the model rate through a windowed-sinc resample
(24k -> 44.1k -> 24k). ``load_silentcipher_params`` maps the published
checkpoint directory (``enc_c.ckpt`` / ``dec_c.ckpt`` / ``dec_m_0.ckpt``,
plain torch state dicts) onto the tree ``init_silentcipher`` makes (random
parameters at the published shapes).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear
from .spectral import hann, overlap_add, reflect_pad


@dataclasses.dataclass(frozen=True)
class SilentCipherConfig:
    n_fft: int = 1024
    hop: int = 512
    sr: int = 44100
    message_dim: int = 5        # one-hot symbols: terminator + 4 2-bit values
    message_len: int = 21       # 5 bytes -> 20 2-bit symbols + terminator
    message_band_size: int = 1024
    enc_layers: int = 3
    dec_layers: int = 4
    msg_dec_layers: int = 10
    msg_dec_dim: int = 128
    message_sdr: float = 36.0
    frame_level_normalization: bool = True
    average_energy_vctk: float = 0.002837200844477648

    @property
    def bins(self) -> int:
        return self.n_fft // 2 + 1


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _init_conv2d(g: torch.Generator, cin: int, cout: int, k: int,
                 device) -> dict:
    scale = 1.0 / math.sqrt(cin * k * k)

    def uniform(shape):
        return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0
                ) * scale

    return {"w": uniform((cout, cin, k, k)), "b": uniform((cout,))}


def _init_gated(g: torch.Generator, cin: int, cout: int, k: int,
                device) -> dict:
    def full(v):
        return torch.full((cout,), v, device=device)

    return {"conv": _init_conv2d(g, cin, cout, k, device),
            "gate": _init_conv2d(g, cin, cout, k, device),
            "bn_w": full(1.0), "bn_b": full(0.0),
            "bn_mean": full(0.0), "bn_var": full(1.0)}


def init_silentcipher(cfg: SilentCipherConfig, generator: torch.Generator,
                      device) -> dict:
    """Random parameters at the published shapes (the JAX init's scales)."""
    g = generator
    enc = [_init_gated(g, 1, 32, 3, device)]
    enc += [_init_gated(g, 32, 32, 3, device)
            for _ in range(cfg.enc_layers - 1)]
    dec = [_init_gated(g, 96, 96, 3, device)
           for _ in range(cfg.dec_layers - 1)]
    dec.append(_init_gated(g, 96, 1, 1, device))
    D = cfg.msg_dec_dim
    msg = [_init_gated(g, 1, D, 3, device)]
    msg += [_init_gated(g, D, D, 3, device)
            for _ in range(cfg.msg_dec_layers - 2)]
    msg.append(_init_gated(g, D, cfg.message_dim, 3, device))
    return {
        "enc_c": {"main": enc,
                  "linear": _init_linear(g, cfg.message_dim,
                                         cfg.message_band_size,
                                         torch.float32, device, bias=True)},
        "dec_c": {"main": dec},
        "dec_m": {"main": msg,
                  "linear": _init_linear(g, cfg.message_band_size, 1,
                                         torch.float32, device, bias=True)},
    }


def load_silentcipher_params(ckpt_dir, cfg: SilentCipherConfig, *,
                             device) -> dict:
    """Map the published checkpoint directory (``enc_c.ckpt``,
    ``dec_c.ckpt``, ``dec_m_0.ckpt``: torch state dicts, ``module.``
    prefixes dropped) onto ``init_silentcipher``'s tree, float32 on
    ``device``. Each gated layer that has a conv is taken, in index
    order."""
    import os

    def sd(name):
        raw = torch.load(os.path.join(ckpt_dir, name), map_location="cpu")
        return {k.replace("module.", ""): v for k, v in raw.items()}

    def f32(t):
        return t.to(device=device, dtype=torch.float32,
                    copy=True).contiguous()

    def gated_stack(d):
        idxs = sorted({int(k.split(".")[1]) for k in d
                       if k.startswith("main.") and ".conv." in k})
        return [{
            "conv": {"w": f32(d[f"main.{i}.conv.weight"]),
                     "b": f32(d[f"main.{i}.conv.bias"])},
            "gate": {"w": f32(d[f"main.{i}.gate.weight"]),
                     "b": f32(d[f"main.{i}.gate.bias"])},
            "bn_w": f32(d[f"main.{i}.bn.weight"]),
            "bn_b": f32(d[f"main.{i}.bn.bias"]),
            "bn_mean": f32(d[f"main.{i}.bn.running_mean"]),
            "bn_var": f32(d[f"main.{i}.bn.running_var"]),
        } for i in idxs]

    def linear_of(d):
        return {"w": f32(d["linear.weight"].T), "b": f32(d["linear.bias"])}

    enc_d, dec_d, msg_d = (sd("enc_c.ckpt"), sd("dec_c.ckpt"),
                           sd("dec_m_0.ckpt"))
    return {
        "enc_c": {"main": gated_stack(enc_d), "linear": linear_of(enc_d)},
        "dec_c": {"main": gated_stack(dec_d)},
        "dec_m": {"main": gated_stack(msg_d), "linear": linear_of(msg_d)},
    }


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _gated_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    pad = (p["conv"]["w"].shape[-1] - 1) // 2
    h = (F.conv2d(x, p["conv"]["w"], p["conv"]["b"], padding=pad)
         * torch.sigmoid(F.conv2d(x, p["gate"]["w"], p["gate"]["b"],
                                  padding=pad)))
    # BatchNorm2d at inference
    h = ((h - p["bn_mean"][None, :, None, None])
         * torch.rsqrt(p["bn_var"][None, :, None, None] + 1e-5))
    return h * p["bn_w"][None, :, None, None] + p["bn_b"][None, :, None, None]


def _stack(ps: list, x: torch.Tensor) -> torch.Tensor:
    for p in ps:
        x = _gated_layer(p, x)
    return x


def sc_stft(cfg: SilentCipherConfig, x: torch.Tensor):
    """x (B, S) -> (mag, phase), each (B, bins, F): torch.stft(center=True)
    semantics after the reference's tail pad to a hop multiple, with its
    epsilon magnitude."""
    n, hop = cfg.n_fft, cfg.hop
    x = F.pad(x, (0, n - x.shape[1] % n))
    spec = torch.fft.rfft(reflect_pad(x, n // 2).unfold(-1, n, hop)
                          * hann(n, x.device), dim=-1)
    sq = torch.square(spec.real) + torch.square(spec.imag)
    eps = (sq == 0).float() * 1e-24
    mag = torch.sqrt(sq + eps) - torch.sqrt(eps)
    phase = torch.atan2(spec.imag, spec.real)
    return mag.transpose(1, 2), phase.transpose(1, 2)


def sc_istft(cfg: SilentCipherConfig, mag: torch.Tensor, phase: torch.Tensor,
             num_samples: int) -> torch.Tensor:
    n, hop = cfg.n_fft, cfg.hop
    comp = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(comp.transpose(1, 2), n=n, dim=-1)
    sig = overlap_add(frames, hann(n, mag.device), hop, 1e-11)[:, n // 2:]
    # the reference trims win_len - (num_samples % win_len) from the end
    return sig[:, :sig.shape[1] - (n - num_samples % n)]


def message_to_symbols(message: list[int], cfg: SilentCipherConfig
                       ) -> np.ndarray:
    """5-byte key -> 20 2-bit symbols + terminator, one-hot (message_dim,
    message_len), tiled over any frame count by ``sc_encode``."""
    bits = "".join(f"{m:08b}" for m in message)
    syms = [int(bits[i * 2:i * 2 + 2], 2) for i in range(len(bits) // 2)]
    index = np.concatenate([np.asarray(syms) + 1, [0]])
    return np.identity(cfg.message_dim)[index].T.astype(np.float32)


def sc_encode(params: dict, cfg: SilentCipherConfig, y: torch.Tensor,
              message_onehot: torch.Tensor,
              message_sdr: float | None = None) -> torch.Tensor:
    """y (B, S) at cfg.sr -> watermarked (B, S) (the reference's encode
    math, without its zero-power early-out)."""
    sdr = cfg.message_sdr if message_sdr is None else message_sdr
    S = y.shape[1]
    power = torch.clamp(torch.mean(torch.square(y), dim=1, keepdim=True),
                        min=1e-12)
    yn = y * torch.sqrt(cfg.average_energy_vctk / power)

    mag, phase = sc_stft(cfg, yn)                        # (B, bins, F)
    carrier = mag[:, None]                               # (B, 1, bins, F)
    B, Fr = mag.shape[0], mag.shape[-1]
    # the one-hot message tiled across frames
    reps = -(-Fr // cfg.message_len)
    msg = message_onehot.repeat(1, reps)[:, :Fr]         # (dim, F)
    msg = msg[None, None].expand(B, 1, -1, -1)           # (B, 1, dim, F)

    enc = params["enc_c"]
    carrier_enc = _stack(enc["main"], carrier)           # (B, 32, bins, F)
    # the message linear over the symbol axis -> band rows, zero-padded to
    # the bins
    m = linear(enc["linear"], msg.transpose(2, 3)).transpose(2, 3)
    m = F.pad(m, (0, 0, 0, cfg.bins - cfg.message_band_size))
    merged = torch.cat([carrier_enc, carrier.expand(-1, 32, -1, -1),
                        m.expand(-1, 32, -1, -1)], dim=1)   # (B, 96, bins, F)
    info = _stack(params["dec_c"]["main"], merged)       # (B, 1, bins, F)
    info = F.pad(info[:, :, :cfg.message_band_size],
                 (0, 0, 0, cfg.bins - cfg.message_band_size))
    info = info / torch.sqrt(torch.mean(torch.square(info), dim=2,
                                        keepdim=True) + 1e-24
                             ) / (10.0 ** (sdr / 20.0))
    if cfg.frame_level_normalization:
        info = info * torch.sqrt(torch.mean(torch.square(carrier), dim=2,
                                            keepdim=True))
    out_mag = torch.abs(info + carrier)[:, 0]
    out = sc_istft(cfg, out_mag, phase, S)
    out = out * torch.sqrt(power / cfg.average_energy_vctk)
    return out[:, :S]


def sc_decode_symbols(params: dict, cfg: SilentCipherConfig,
                      y: torch.Tensor) -> torch.Tensor:
    """y (B, S) -> per-frame symbol predictions (B, F) via the message
    decoder."""
    power = torch.mean(torch.square(y), dim=1, keepdim=True)
    yn = y * torch.sqrt(cfg.average_energy_vctk / torch.clamp(power,
                                                              min=1e-12))
    mag, _ = sc_stft(cfg, yn)
    h = _stack(params["dec_m"]["main"],
               mag[:, None, :cfg.message_band_size])     # (B, dim, band, F)
    h = linear(params["dec_m"]["linear"], h.transpose(2, 3))[..., 0]
    return torch.argmax(h, dim=1)


# ---------------------------------------------------------------------------
# resample (24 kHz serving audio <-> 44.1 kHz model rate)
# ---------------------------------------------------------------------------


def _resample_filter(up: int, down: int, zeros: int = 12) -> np.ndarray:
    """Windowed-sinc lowpass for polyphase resampling by up/down, designed
    at the zero-stuffed rate (x up): cutoff at the tighter Nyquist, ``zeros``
    zero crossings per side, hann window, DC gain ``up`` (compensating the
    1/up amplitude of zero-stuffing)."""
    fc = 0.5 / max(up, down)  # cycles per upsampled sample
    taps = 2 * zeros * max(up, down) + 1
    t = np.arange(taps) - taps // 2
    h = 2 * fc * np.sinc(2 * fc * t)
    h *= np.hanning(taps)
    return (h * (up / h.sum())).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _filter_tensor(up: int, down: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The filter on the device, made once per (rates, device, dtype): a
    first, uncaptured call makes it, so a captured call copies nothing from
    the host."""
    return torch.from_numpy(_resample_filter(up, down)).to(device, dtype)


def sinc_resample(x: torch.Tensor, orig_sr: int, new_sr: int,
                  out_len: str = "floor") -> torch.Tensor:
    """Polyphase windowed-sinc resample along the last axis (any leading
    dims). ``out_len``: "floor" (S * up // down) or "ceil"."""
    if orig_sr == new_sr:
        return x
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    lead, S = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, S)
    h = _filter_tensor(up, down, flat.device, flat.dtype)
    xe = torch.zeros((flat.shape[0], S * up), dtype=flat.dtype,
                     device=flat.device)
    xe[:, ::up] = flat
    pad = h.shape[0] // 2
    y = F.conv1d(xe[:, None], h[None, None], stride=down, padding=pad)[:, 0]
    n_out = -(-S * up // down) if out_len == "ceil" else S * up // down
    return y[:, :n_out].reshape(lead + (n_out,))
