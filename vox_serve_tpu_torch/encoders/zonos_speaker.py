"""Zonos speaker-embedding network (port of
vox_serve_tpu/encoders/zonos_speaker.py): ResNet293/SimAM + ASP + LDA.

Log-mel fbank (host numpy) -> ResNet293 (SimAM basic blocks, [10, 20, 64,
3]) -> attentive-statistics pooling -> 256-d bottleneck -> LDA linear ->
the 128-d conditioning vector. Checkpoints are the two ``.pt`` files of
Zyphra/Zonos-v0.1-speaker-embedding. The forward runs eagerly on the
model's device at preprocess time in float32 (cuDNN's conv2d; the worker
turns TF32 off), as the JAX package runs it through
``lax.conv_general_dilated``; the batch norms are in inference form.
Callers truncate the waveform to 0.5 s steps, as the JAX package does to
bound its executables.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..weights import to_device

MEL_SR = 16000
N_FFT = 512
WIN = 400  # 0.025 s
HOP = 160  # 0.010 s
N_MELS = 80
NUM_BLOCKS = (10, 20, 64, 3)
IN_PLANES = 64


# ---------------------------------------------------------------------------
# log-mel front end (torchaudio MelSpectrogram defaults: power 2, HTK mel
# scale, no norm, center/reflect padding, Hann window), host numpy
# ---------------------------------------------------------------------------
def _htk_mel_filterbank() -> np.ndarray:
    n_freqs = N_FFT // 2 + 1
    all_freqs = np.linspace(0, MEL_SR / 2, n_freqs)
    m_min = 2595.0 * math.log10(1.0 + 0.0 / 700.0)
    m_max = 2595.0 * math.log10(1.0 + (MEL_SR / 2) / 700.0)
    m_pts = np.linspace(m_min, m_max, N_MELS + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (freq, mel+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)  # (n_freqs, n_mels)


_MEL_FB = _htk_mel_filterbank()


def log_fbank(wav: np.ndarray) -> np.ndarray:
    """(T,) float32 at 16 kHz -> (1, 80, frames) log-mel, mean-subtracted
    per mel bin (reference logFbankCal, encoder/zonos.py:14-36)."""
    x = np.asarray(wav, np.float32)
    pad = N_FFT // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP
    window = np.hanning(WIN + 1)[:-1].astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(x, N_FFT)[::HOP][:n_frames]
    # torchaudio pads the window to n_fft (win centered)
    wpad = np.zeros(N_FFT, np.float32)
    off = (N_FFT - WIN) // 2
    wpad[off:off + WIN] = window
    spec = np.abs(np.fft.rfft(frames * wpad, axis=-1)) ** 2  # (frames, freq)
    mel = spec @ _MEL_FB  # (frames, n_mels)
    out = np.log(mel.T + 1e-6)  # (n_mels, frames)
    out = out - out.mean(axis=1, keepdims=True)
    return out[None]


def resample_to_16k(wav: np.ndarray, sr: int) -> np.ndarray:
    """Linear interpolation to 16 kHz (the JAX package's resampler)."""
    if sr == MEL_SR:
        return np.asarray(wav, np.float32)
    n_out = int(round(len(wav) * MEL_SR / sr))
    pos = np.linspace(0.0, len(wav) - 1, n_out)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, len(wav) - 1)
    frac = (pos - i0).astype(np.float32)
    w = np.asarray(wav, np.float32)
    return w[i0] * (1 - frac) + w[i1] * frac


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def load_zonos_speaker_params(sd: dict, lda_sd: dict | None = None, *,
                              device="cpu") -> dict:
    """Map the ResNet293_SimAM_ASP_base.pt state dict (+ the optional
    LDA-128 one; torch tensors or numpy arrays) onto the parameter tree,
    float32 on ``device``."""
    def arr(a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    def conv(n):
        p = {"w": arr(sd[f"{n}.weight"])}
        if f"{n}.bias" in sd:
            p["b"] = arr(sd[f"{n}.bias"])
        return p

    def bn(n):
        return {"scale": arr(sd[f"{n}.weight"]), "bias": arr(sd[f"{n}.bias"]),
                "mean": arr(sd[f"{n}.running_mean"]),
                "var": arr(sd[f"{n}.running_var"])}

    def block(pre):
        b = {"conv1": conv(f"{pre}.conv1"), "bn1": bn(f"{pre}.bn1"),
             "conv2": conv(f"{pre}.conv2"), "bn2": bn(f"{pre}.bn2")}
        if f"{pre}.downsample.0.weight" in sd:
            b["down_conv"] = conv(f"{pre}.downsample.0")
            b["down_bn"] = bn(f"{pre}.downsample.1")
        return b

    front = {"conv1": conv("front.conv1"), "bn1": bn("front.bn1")}
    for li, n in enumerate(NUM_BLOCKS, start=1):
        front[f"layer{li}"] = [block(f"front.layer{li}.{i}")
                               for i in range(n)]
    params = {
        "front": front,
        "asp": {
            "att_conv1": conv("pooling.attention.0"),
            "att_bn": bn("pooling.attention.2"),
            "att_conv2": conv("pooling.attention.3"),
        },
        "bottleneck": {"w": arr(sd["bottleneck.weight"]),
                       "b": arr(sd["bottleneck.bias"])},
    }
    if lda_sd is not None:
        params["lda"] = {"w": arr(lda_sd["weight"]), "b": arr(lda_sd["bias"])}
    return params


def init_zonos_speaker_params(generator: torch.Generator, device,
                              scale_blocks: tuple = NUM_BLOCKS,
                              in_planes: int = IN_PLANES,
                              acoustic_dim: int = N_MELS) -> dict:
    """Random init in the reference's exact shapes and the JAX init's
    scales (the numbers come from ``generator``, which lives on
    ``device``)."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def zeros(c):
        return torch.zeros((c,), dtype=torch.float32, device=device)

    def conv(cin, cout, k):
        return {"w": randn(cout, cin, k, k) / math.sqrt(cin * k * k)}

    def conv1d_(cin, cout):
        return {"w": randn(cout, cin, 1) * 0.05, "b": zeros(cout)}

    def bn(c):
        return {"scale": zeros(c) + 1, "bias": zeros(c), "mean": zeros(c),
                "var": zeros(c) + 1}

    front = {"conv1": conv(1, in_planes, 3), "bn1": bn(in_planes)}
    cur = in_planes
    for li, n in enumerate(scale_blocks, start=1):
        planes = in_planes * (2 ** (li - 1))
        stride0 = 1 if li == 1 else 2
        blocks = []
        for i in range(n):
            b = {"conv1": conv(cur, planes, 3), "bn1": bn(planes),
                 "conv2": conv(planes, planes, 3), "bn2": bn(planes)}
            if (stride0 if i == 0 else 1) != 1 or cur != planes:
                b["down_conv"] = conv(cur, planes, 1)
                b["down_bn"] = bn(planes)
            blocks.append(b)
            cur = planes
        front[f"layer{li}"] = blocks
    feat = in_planes * 8 * (acoustic_dim // 8)
    return {
        "front": front,
        "asp": {"att_conv1": conv1d_(feat, 128), "att_bn": bn(128),
                "att_conv2": conv1d_(128, feat)},
        "bottleneck": {"w": randn(256, feat * 2) * 0.01, "b": zeros(256)},
        "lda": {"w": randn(128, 256) * 0.1, "b": zeros(128)},
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _conv2d(p, x, stride=1):
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p.get("b"), stride=stride,
                    padding=(k - 1) // 2)


def _bn(p, x):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(p["var"] + 1e-5)
    return ((x - p["mean"].reshape(shape)) * (inv * p["scale"]).reshape(shape)
            + p["bias"].reshape(shape))


def _simam(x, lambda_p=1e-4):
    n = x.shape[2] * x.shape[3] - 1
    d = torch.square(x - x.mean(dim=(2, 3), keepdim=True))
    v = d.sum(dim=(2, 3), keepdim=True) / n
    e_inv = d / (4 * (v + lambda_p)) + 0.5
    return x * torch.sigmoid(e_inv)


def _simam_block(p, x, stride):
    out = F.relu(_bn(p["bn1"], _conv2d(p["conv1"], x, stride)))
    out = _simam(_bn(p["bn2"], _conv2d(p["conv2"], out)))
    if "down_conv" in p:
        x = _bn(p["down_bn"], _conv2d(p["down_conv"], x, stride))
    return F.relu(out + x)


def zonos_speaker_forward(params: dict, mel: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel: (1, 80, T) log-fbank on the params' device. Returns (the
    256-d embedding, the 128-d LDA vector; the embedding again without
    an LDA)."""
    f = params["front"]
    x = F.relu(_bn(f["bn1"], _conv2d(f["conv1"], mel[:, None])))
    for li in range(1, 5):
        stride0 = 1 if li == 1 else 2
        for i, b in enumerate(f[f"layer{li}"]):
            x = _simam_block(b, x, stride0 if i == 0 else 1)

    # ASP: (B, C, H, W) -> (B, C*H, W) (reference encoder/zonos.py:54-61)
    B, C, H, W = x.shape
    x = x.reshape(B, C * H, W)
    a = params["asp"]

    def conv1(p, y):  # pointwise Conv1d: weight (out, in, 1)
        return F.conv1d(y, p["w"], p["b"])

    w = _bn(a["att_bn"], F.relu(conv1(a["att_conv1"], x)))
    w = torch.softmax(conv1(a["att_conv2"], w), dim=2)
    mu = torch.sum(x * w, dim=2)
    sg = torch.sqrt(torch.clamp(torch.sum(torch.square(x) * w, dim=2)
                                - torch.square(mu), min=1e-5))
    pooled = torch.cat([mu, sg], dim=1).reshape(B, -1)

    emb = pooled @ params["bottleneck"]["w"].T + params["bottleneck"]["b"]
    lda = emb
    if "lda" in params:
        lda = emb @ params["lda"]["w"].T + params["lda"]["b"]
    return emb[0], lda[0]


def extract_speaker_embedding(params: dict, wav: np.ndarray,
                              sr: int) -> np.ndarray:
    """The reference pipeline: resample -> log-fbank -> network -> LDA, the
    waveform truncated to 0.5 s steps (at least one). Returns the (128,)
    float32 vector on the host."""
    wav16 = resample_to_16k(np.asarray(wav, np.float32), sr)
    step = MEL_SR // 2
    n = max(step, (len(wav16) // step) * step)
    mel = log_fbank(wav16[:n])
    dev = params["bottleneck"]["w"].device
    with torch.no_grad():
        _, lda = zonos_speaker_forward(
            params, torch.from_numpy(np.ascontiguousarray(
                mel, np.float32)).to(dev))
    return lda.float().cpu().numpy()
