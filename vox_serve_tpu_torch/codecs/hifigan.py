"""HiFT (NSF-HiFiGAN + ISTFTNet) vocoder (port of
vox_serve_tpu/codecs/hifigan.py): the mel -> waveform stage of CosyVoice2
and GLM-4-Voice.

A conv F0 predictor -> a harmonic sine source (NSF) -> the upsampling
HiFiGAN trunk with Snake residual blocks and STFT-domain source injection
(CosyVoice2's three upsample levels at 24 kHz, GLM-4-Voice's two at 22.05
kHz; the config sets them) -> an inverse-STFT head (magnitude = exp, phase = sin; hann window, n_fft
16, hop 4). The source is deterministic (no additive noise, zero initial
phase), as the JAX package serves it. Streaming keeps the source
continuous through a cache of the excitation already generated, and
crossfades each chunk's head into the previous chunk's held-back tail.

Every constant (the harmonic numbers, the hann and hamming windows, the
frame and overlap-add indices) is made on the tensors' device by kernels,
so ``hift_decode`` and ``hift_decode_chunk`` run inside a captured CUDA
graph. ``torch.fft`` takes no bfloat16: under a bf16 codec the STFT and
its inverse run in float32 and cast back, as the spectral watermark does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..watermark.spectral import hann, overlap_add, reflect_pad
from .layers import (conv1d, conv_transpose1d, fold_weight_norm, init_conv1d,
                     init_conv_transpose1d, snake)


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: tuple[int, ...] = (16, 11, 7)
    n_fft: int = 16
    hop_len: int = 4
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernel_sizes: tuple[int, ...] = (7, 7, 11)
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        """Samples per mel frame: 480 at CosyVoice2's (8, 5, 3) x hop 4,
        256 at GLM-4-Voice's (8, 8)."""
        return int(math.prod(self.upsample_rates)) * self.hop_len

    @property
    def source_down(self) -> list[int]:
        """The stride of each level's source-downsampling conv."""
        return [int(d) for d in np.cumprod(
            [1] + list(self.upsample_rates[::-1][:-1]))[::-1]]


def _get_padding(kernel, dilation=1):
    return (kernel * dilation - dilation) // 2


def init_hift(cfg: HiFTConfig, generator: torch.Generator, device) -> dict:
    """Random parameters at ``cfg``'s widths (the JAX init's shapes and
    scales; the numbers come from ``generator``), float32."""
    g, dev = generator, device

    def conv(cin, cout, k):
        return init_conv1d(g, cin, cout, k, dev)

    def resblock(ch, kernel, dilations):
        return {
            "convs1": [conv(ch, ch, kernel) for _ in dilations],
            "convs2": [conv(ch, ch, kernel) for _ in dilations],
            "alpha1": [torch.ones((ch,), device=dev) for _ in dilations],
            "alpha2": [torch.ones((ch,), device=dev) for _ in dilations],
        }

    p: dict = {
        "f0_convs": [conv(cfg.in_channels if i == 0 else
                          cfg.f0_cond_channels, cfg.f0_cond_channels, 3)
                     for i in range(5)],
        "f0_out_w": torch.randn((cfg.f0_cond_channels, 1), generator=g,
                                device=dev) * 0.02,
        "f0_out_b": torch.zeros((1,), device=dev),
        "source_linear_w": torch.randn((cfg.nb_harmonics + 1, 1),
                                       generator=g, device=dev) * 0.3,
        "source_linear_b": torch.zeros((1,), device=dev),
        "conv_pre": conv(cfg.in_channels, cfg.base_channels, 7),
        "ups": [], "source_downs": [], "source_resblocks": [],
        "resblocks": [],
    }
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        cin = cfg.base_channels // (2 ** i)
        cout = cfg.base_channels // (2 ** (i + 1))
        p["ups"].append(init_conv_transpose1d(g, cin, cout, k, dev))
        d = cfg.source_down[i]
        p["source_downs"].append(conv(cfg.n_fft + 2, cout,
                                      1 if d == 1 else d * 2))
        p["source_resblocks"].append(
            resblock(cout, cfg.source_resblock_kernel_sizes[i],
                     cfg.resblock_dilations[i]))
        for k2, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
            p["resblocks"].append(resblock(cout, k2, dil))
    final_ch = cfg.base_channels // (2 ** len(cfg.upsample_rates))
    p["conv_post"] = conv(final_ch, cfg.n_fft + 2, 7)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _resblock(p, x, kernel, dilations):
    for i, dil in enumerate(dilations):
        xt = snake(x, p["alpha1"][i])
        xt = conv1d(p["convs1"][i], xt, padding=_get_padding(kernel, dil),
                    dilation=dil)
        xt = snake(xt, p["alpha2"][i])
        xt = conv1d(p["convs2"][i], xt, padding=_get_padding(kernel, 1))
        x = x + xt
    return x


def _f0_predictor(p, mel):
    x = mel
    for conv in p["f0_convs"]:
        x = F.elu(conv1d(conv, x, padding=1))
    f0 = torch.abs(x.transpose(1, 2) @ p["f0_out_w"].to(x.dtype)
                   + p["f0_out_b"].to(x.dtype))
    return f0[:, :, 0]                                         # (B, T)


def _sine_source(p, cfg: HiFTConfig, f0_frames: torch.Tensor
                 ) -> torch.Tensor:
    """f0_frames (B, T) Hz -> source excitation (B, 1, T * total_upsample):
    harmonic sines whose phase integrates over every sample (a float32
    cumsum), zero where unvoiced, mixed by the source linear layer."""
    f0 = torch.repeat_interleave(f0_frames.float(), cfg.total_upsample,
                                 dim=1)                        # (B, S)
    harmonics = torch.arange(1, cfg.nb_harmonics + 2, device=f0.device,
                             dtype=torch.float32)
    rad = (f0[:, :, None] * harmonics[None, None, :]) / cfg.sampling_rate
    phase = 2.0 * math.pi * torch.cumsum(torch.remainder(rad, 1.0), dim=1)
    uv = (f0 > cfg.nsf_voiced_threshold).float()[:, :, None]
    sines = cfg.nsf_alpha * torch.sin(phase) * uv              # (B, S, H+1)
    merged = torch.tanh(sines @ p["source_linear_w"].float()
                        + p["source_linear_b"].float())
    return merged.transpose(1, 2)                              # (B, 1, S)


def _stft_18(cfg: HiFTConfig, s: torch.Tensor) -> torch.Tensor:
    """The centered STFT of the source: (B, S) -> (B, n_fft + 2, S / hop +
    1), real parts then imaginary parts, in float32."""
    n, hop = cfg.n_fft, cfg.hop_len
    frames = reflect_pad(s.float(), n // 2).unfold(-1, n, hop) * hann(
        n, s.device)
    spec = torch.fft.rfft(frames, dim=-1)                      # (B, F, n/2+1)
    return torch.cat([spec.real, spec.imag], dim=-1).transpose(1, 2)


def _istft(cfg: HiFTConfig, mag: torch.Tensor, phase: torch.Tensor
           ) -> torch.Tensor:
    """(B, n/2+1, F) magnitude / phase -> (B, samples): the windowed
    overlap-add inverse STFT, divided by the summed squared window, the
    centering pad cut off; float32."""
    n, hop = cfg.n_fft, cfg.hop_len
    mag = torch.clamp(mag.float(), max=1e2)
    phase = phase.float()
    comp = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(comp.transpose(1, 2), n=n, dim=-1)  # (B, F, n)
    sig = overlap_add(frames, hann(n, mag.device), hop, 1e-8)
    return sig[:, n // 2:-(n // 2)]


def hift_decode(params: dict, cfg: HiFTConfig, mel: torch.Tensor,
                source_cache: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel (B, in_channels, T) -> (waveform (B, T * total_upsample), source
    (B, 1, T * total_upsample)). ``source_cache`` (B, 1, S_prev): the excitation of the previous
    chunks, which overwrites the head of this chunk's source (phase
    continuity)."""
    dtype = params["conv_pre"]["w"].dtype
    f0 = _f0_predictor(params, mel)
    s = _sine_source(params, cfg, f0)
    if source_cache is not None and source_cache.shape[2] > 0:
        keep = source_cache.shape[2]
        s = torch.cat([source_cache.to(s.dtype), s[:, :, keep:]], dim=2)
    s_stft = _stft_18(cfg, s[:, 0]).to(dtype)                  # (B, 18, F)

    x = conv1d(params["conv_pre"], mel, padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        x = conv_transpose1d(params["ups"][i], x, stride=u,
                             padding=(k - u) // 2)
        if i == len(cfg.upsample_rates) - 1:
            x = F.pad(x, (1, 0), mode="reflect")
        d = cfg.source_down[i]
        if d == 1:
            si = conv1d(params["source_downs"][i], s_stft)
        else:
            si = conv1d(params["source_downs"][i], s_stft, stride=d,
                        padding=d // 2)
        si = _resblock(params["source_resblocks"][i], si,
                       cfg.source_resblock_kernel_sizes[i],
                       cfg.resblock_dilations[i])
        x = x + si
        xs = None
        for j in range(nk):
            r = _resblock(params["resblocks"][i * nk + j], x,
                          cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilations[j])
            xs = r if xs is None else xs + r
        x = xs / nk

    x = conv1d(params["conv_post"], F.leaky_relu(x, 0.01), padding=3)
    half = cfg.n_fft // 2 + 1
    wav = _istft(cfg, torch.exp(x[:, :half, :].float()),
                 torch.sin(x[:, half:, :].float()))
    wav = torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)
    return wav.to(dtype), s


def load_hift_params(sd: dict, cfg: HiFTConfig, prefix: str = "", *,
                     device="cpu") -> dict:
    """Map the published ``hift.pt`` (``HiFTGenerator.state_dict()``, its
    ``generator.`` prefix stripped) onto ``init_hift``'s tree, float32 on
    ``device``. Weight-norm pairs (``weight_g`` / ``weight_v``, or the
    parametrized ``original0`` / ``original1``) are folded on the host in
    numpy, as the JAX loader folds them."""
    def arr(name):
        a = sd[prefix + name]
        return a.detach().cpu().float().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float32))).to(device)

    def wn_conv(name):
        if prefix + name + ".weight_g" in sd:
            w = fold_weight_norm(arr(f"{name}.weight_g"),
                                 arr(f"{name}.weight_v"))
        elif prefix + name + ".parametrizations.weight.original0" in sd:
            w = fold_weight_norm(
                arr(f"{name}.parametrizations.weight.original0"),
                arr(f"{name}.parametrizations.weight.original1"))
        else:
            w = arr(f"{name}.weight")
        p = {"w": dev(w)}
        if prefix + name + ".bias" in sd:
            p["b"] = dev(arr(f"{name}.bias"))
        return p

    def conv(name):
        p = {"w": dev(arr(f"{name}.weight"))}
        if prefix + name + ".bias" in sd:
            p["b"] = dev(arr(f"{name}.bias"))
        return p

    def resblock(name, n=3):
        return {
            "convs1": [wn_conv(f"{name}.convs1.{j}") for j in range(n)],
            "convs2": [wn_conv(f"{name}.convs2.{j}") for j in range(n)],
            "alpha1": [dev(arr(f"{name}.activations1.{j}.alpha").reshape(-1))
                       for j in range(n)],
            "alpha2": [dev(arr(f"{name}.activations2.{j}.alpha").reshape(-1))
                       for j in range(n)],
        }

    n_up = len(cfg.upsample_rates)
    n_k = len(cfg.resblock_kernel_sizes)
    return {
        "f0_convs": [wn_conv(f"f0_predictor.condnet.{2 * i}")
                     for i in range(5)],
        "f0_out_w": dev(arr("f0_predictor.classifier.weight").T),
        "f0_out_b": dev(arr("f0_predictor.classifier.bias")),
        "source_linear_w": dev(arr("m_source.l_linear.weight").T),
        "source_linear_b": dev(arr("m_source.l_linear.bias")),
        "conv_pre": wn_conv("conv_pre"),
        "ups": [wn_conv(f"ups.{i}") for i in range(n_up)],
        "source_downs": [conv(f"source_downs.{i}") for i in range(n_up)],
        "source_resblocks": [
            resblock(f"source_resblocks.{i}",
                     len(cfg.resblock_dilations[i])) for i in range(n_up)],
        "resblocks": [resblock(f"resblocks.{i * n_k + j}",
                               len(cfg.resblock_dilations[j]))
                      for i in range(n_up) for j in range(n_k)],
        "conv_post": wn_conv("conv_post"),
    }


# ---------------------------------------------------------------------------
# streaming (chunked) decode
# ---------------------------------------------------------------------------

#: mel frames of context carried between chunks
HIFT_CTX_FRAMES = 6


def init_hift_cache(cfg: HiFTConfig, batch: int, device,
                    ctx_frames: int = HIFT_CTX_FRAMES) -> dict:
    """Per-slot streaming state: ``mel`` context frames, the ``source``
    excitation tail (phase continuity), the held-back ``speech`` tail (the
    crossfade), and ``primed``, False until the slot's first chunk."""
    up = cfg.total_upsample
    return {
        "mel": torch.zeros((batch, cfg.in_channels, ctx_frames),
                           device=device),
        "source": torch.zeros((batch, 1, ctx_frames * up), device=device),
        "speech": torch.zeros((batch, ctx_frames * up), device=device),
        "primed": torch.zeros((batch,), dtype=torch.bool, device=device),
    }


def _hamming(n: int, device) -> torch.Tensor:
    """``np.hamming(n)``, float32, made on the device."""
    return torch.hamming_window(n, periodic=False, dtype=torch.float64,
                                device=device).float()


def hift_decode_chunk(params: dict, cfg: HiFTConfig, mel: torch.Tensor,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """One streaming chunk: mel (B, C, T) new frames -> (wav (B, T *
    total_upsample), new cache). Prepends the cached context mel, overwrites the
    regenerated source head with the cached excitation, Hamming-crossfades
    the head into the previous chunk's held-back tail (muted in a slot's
    first chunk, whose head decodes the all-zero context), and holds back
    this chunk's tail: the output lags offline decode by the context."""
    ctx = cache["mel"].shape[2]
    n = ctx * cfg.total_upsample
    mel_in = torch.cat([cache["mel"].to(mel.dtype), mel], dim=2)
    wav, source = hift_decode(params, cfg, mel_in,
                              source_cache=cache["source"])
    window = _hamming(2 * n, mel.device).to(wav.dtype)
    head = wav[:, :n] * window[None, :n] \
        + cache["speech"].to(wav.dtype) * window[None, n:]
    head = torch.where(cache["primed"][:, None], head, torch.zeros_like(head))
    wav = torch.cat([head, wav[:, n:]], dim=1)
    new_cache = {
        "mel": mel_in[:, :, -ctx:],
        "source": source[:, :, -n:],
        "speech": wav[:, -n:],
        "primed": torch.ones_like(cache["primed"]),
    }
    return wav[:, :-n], new_cache
