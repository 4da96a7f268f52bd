"""The Whisper log-mel front end, GLM-4-Voice's Whisper-VQ speech
tokenizer and Step-Audio 2's audio encoder and adaptor (port of
vox_serve_tpu/encoders/whisper_exact.py: the S3 v2 tokenizer's and the
encoders' input features, and the encoders).

GLM Whisper-VQ (the published ``zai-org/glm-4-voice-tokenizer``): 128-mel
Whisper features -> two causal convs (left-padded, the second with stride
2) with exact GELU -> learned positions -> 16 pre-LN transformer layers
(width 1280, 20 heads, FFN 5120, no bias on the key projection) under a
block-causal mask (all of the past plus the whole current 200-frame block,
padded keys masked) -> a x4 average pool -> the nearest of 16,384 codebook
rows: discrete speech tokens at 12.5 Hz. Linear weights keep torch's
``(out, in)`` layout, as the JAX package keeps them. It runs eagerly on the
model's device at preprocess time, in float32 with TF32 off (matmuls and
cuDNN convolutions), so that the argmin over the codebook sees full
float32 distances.

Step-Audio 2 (Whisper-large-v3 shaped): 128-mel features -> conv k3 s1 and
conv k3 s2 (both padded 1, exact GELU) -> learned positions -> 32 pre-LN
layers (width 1280, 20 heads, FFN 5120, no bias on the key projection)
under a key-padding mask -> a x2 average pool -> LayerNorm; then the
adaptor (conv k7 s4, GELU, linear 1280 -> 2048, ReLU, linear -> 3584)
turns each pooled pair of frames into an LLM embedding row, spliced over
the prompt's ``<audio>`` marker rows. Also eager, float32, TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norms import layer_norm
from ..weights import to_device

NEG = float(np.finfo(np.float32).min)


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


# ---------------------------------------------------------------------------
# shared transformer pieces
# ---------------------------------------------------------------------------
def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].T
    if "b" in p:
        y = y + p["b"]
    return y


def _attn(lp: dict, x: torch.Tensor, mask, heads: int) -> torch.Tensor:
    """Pre-LN Whisper attention. mask: (T, T) additive, or None."""
    B, T, D = x.shape
    hd = D // heads
    q, k, v = (_linear(lp[n], x).reshape(B, T, heads, hd).transpose(1, 2)
               for n in ("q", "k", "v"))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = s + mask[None, None]
    a = torch.softmax(s, dim=-1) @ v
    return _linear(lp["o"], a.transpose(1, 2).reshape(B, T, D))


def _layer(lp: dict, x: torch.Tensor, mask, heads: int) -> torch.Tensor:
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    x = x + _attn(lp, h, mask, heads)
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    return x + _linear(lp["fc2"], F.gelu(_linear(lp["fc1"], h)))


def _causal_conv1d(w, b, x, stride: int) -> torch.Tensor:
    """CausalConv1d: left pad of k - 1."""
    return F.conv1d(F.pad(x, (w.shape[-1] - 1, 0)), w, b, stride=stride)


def _conv1d(w, b, x, stride: int, padding: int) -> torch.Tensor:
    return F.conv1d(x, w, b, stride=stride, padding=padding)


def _map_layer(sd: dict, pre: str, names, device) -> dict:
    """One Whisper layer of a torch state dict under ``pre`` (q, k, v, o,
    ln1, fc1, fc2, ln2 as the published names), float32 on ``device``."""
    q, k, v, o, ln1, fc1, fc2, ln2 = names

    def arr(n):
        a = sd[n]
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    def t(n):
        p = {"w": arr(f"{pre}.{n}.weight")}
        if f"{pre}.{n}.bias" in sd:
            p["b"] = arr(f"{pre}.{n}.bias")
        return p

    return {"q": t(q), "k": t(k), "v": t(v), "o": t(o),
            "ln1_w": arr(f"{pre}.{ln1}.weight"),
            "ln1_b": arr(f"{pre}.{ln1}.bias"),
            "fc1": t(fc1), "fc2": t(fc2),
            "ln2_w": arr(f"{pre}.{ln2}.weight"),
            "ln2_b": arr(f"{pre}.{ln2}.bias")}


@contextlib.contextmanager
def full_float32():
    """Matmuls and cuDNN convolutions in full float32 (TF32 off) inside the
    block; the previous settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# GLM Whisper-VQ
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GLMVQConfig:
    n_mels: int = 128
    d_model: int = 1280
    heads: int = 20
    ffn: int = 5120
    layers: int = 16              # quantize_position
    pool: int = 4                 # pooling_kernel_size at pooling_position
    block: int = 200              # quantize_causal_block_size
    vocab: int = 16384
    max_positions: int = 1500


def load_glm_vq_params(sd: dict, cfg: GLMVQConfig, *, device="cpu") -> dict:
    """Map the published tokenizer's state dict (``WhisperVQEncoder``
    names; torch tensors or numpy arrays) onto ``init_glm_vq_params``'
    tree, float32 on ``device``."""
    def arr(n):
        a = sd[n]
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    return {
        "conv1_w": arr("conv1.weight"), "conv1_b": arr("conv1.bias"),
        "conv2_w": arr("conv2.weight"), "conv2_b": arr("conv2.bias"),
        "pos": arr("embed_positions.weight"),
        "codebook": arr("codebook.weight"),
        "layers": [_map_layer(
            sd, f"layers.{i}",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
             "final_layer_norm"), device) for i in range(cfg.layers)],
    }


def init_glm_vq_params(generator: torch.Generator, cfg: GLMVQConfig,
                       device) -> dict:
    """Random parameters at ``cfg``'s widths (the JAX init's shapes and
    scales; the numbers come from ``generator``), float32."""
    g, dev = generator, device

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def lin(cin, cout, bias=True):
        p = {"w": normal((cout, cin), 1.0 / math.sqrt(cin))}
        if bias:
            p["b"] = torch.zeros((cout,), device=dev)
        return p

    D = cfg.d_model
    ones, zeros = (lambda: torch.ones((D,), device=dev),
                   lambda: torch.zeros((D,), device=dev))
    return {
        "conv1_w": normal((D, cfg.n_mels, 3), 0.05), "conv1_b": zeros(),
        "conv2_w": normal((D, D, 3), 0.02), "conv2_b": zeros(),
        "pos": normal((cfg.max_positions, D), 0.02),
        "codebook": normal((cfg.vocab, D)),
        "layers": [{
            "q": lin(D, D), "k": lin(D, D, bias=False), "v": lin(D, D),
            "o": lin(D, D), "ln1_w": ones(), "ln1_b": zeros(),
            "fc1": lin(D, cfg.ffn), "fc2": lin(cfg.ffn, D),
            "ln2_w": ones(), "ln2_b": zeros(),
        } for _ in range(cfg.layers)],
    }


def glm_vq_block_mask(T: int, block: int, valid_frames: int | None,
                      device) -> torch.Tensor:
    """(T, T) additive mask: frame i attends j iff j <= i or j lies in i's
    ``block``-frame block, and j < ``valid_frames``."""
    idx = torch.arange(T, device=device)
    blk = idx // block
    allowed = (idx[:, None] >= idx[None, :]) | (blk[:, None] == blk[None, :])
    if valid_frames is not None:
        allowed = allowed & (idx[None, :] < valid_frames)
    return torch.where(allowed, 0.0, NEG)


def glm_vq_distances(params: dict, cfg: GLMVQConfig, mel: torch.Tensor,
                     valid_frames: int | None = None) -> torch.Tensor:
    """mel (B, n_mels, T_mel) -> squared distances (B, T_mel // 8, vocab)
    of each pooled frame to every codebook row."""
    with full_float32():
        x = F.gelu(_causal_conv1d(params["conv1_w"], params["conv1_b"],
                                  mel.float(), 1))
        x = F.gelu(_causal_conv1d(params["conv2_w"], params["conv2_b"], x,
                                  2))
        x = x.transpose(1, 2)  # (B, T, D)
        B, T, D = x.shape
        x = x + params["pos"][:T][None]
        mask = glm_vq_block_mask(T, cfg.block, valid_frames, x.device)
        for lp in params["layers"]:
            x = _layer(lp, x, mask, cfg.heads)
        # avg-pool x4, the tail zero-padded
        pad = (-T) % cfg.pool
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        x = x.reshape(B, (T + pad) // cfg.pool, cfg.pool, D).mean(dim=2)
        cb = params["codebook"]
        return (torch.sum(x * x, -1, keepdim=True) - 2 * x @ cb.T
                + torch.sum(cb * cb, -1)[None, None])


def glm_vq_encode(params: dict, cfg: GLMVQConfig, mel: torch.Tensor,
                  valid_frames: int | None = None) -> torch.Tensor:
    """mel (B, n_mels, T_mel) -> speech tokens (B, T_mel // 8) int32.
    ``valid_frames``: the encoder frames (after the stride-2 conv) that
    are not padding."""
    d = glm_vq_distances(params, cfg, mel, valid_frames)
    return torch.argmin(d, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Step-Audio 2 encoder + adaptor
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepEncConfig:
    n_mels: int = 128
    d_model: int = 1280
    heads: int = 20
    layers: int = 32
    max_positions: int = 1500
    llm_dim: int = 3584
    adapter_hidden: int = 2048
    adapter_kernel: int = 7
    adapter_stride: int = 4


def load_step_encoder_params(sd: dict, cfg: StepEncConfig,
                             enc_prefix: str = "encoder.",
                             ada_prefix: str = "adapter.", *,
                             device="cpu") -> dict:
    """Map Step-Audio 2's audio encoder (``encoder.*``) and adaptor
    (``adapter.*``), which sit in the LM's own safetensors, onto
    ``init_step_encoder_params``' tree, float32 on ``device``."""
    def arr(n):
        a = sd[n]
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    return {
        "conv1_w": arr(f"{enc_prefix}conv1.weight"),
        "conv1_b": arr(f"{enc_prefix}conv1.bias"),
        "conv2_w": arr(f"{enc_prefix}conv2.weight"),
        "conv2_b": arr(f"{enc_prefix}conv2.bias"),
        "pos": arr(f"{enc_prefix}positional_embedding.weight"),
        "layers": [_map_layer(
            sd, f"{enc_prefix}blocks.{i}",
            ("attn.query", "attn.key", "attn.value", "attn.out",
             "attn_ln", "mlp.0", "mlp.2", "mlp_ln"), device)
            for i in range(cfg.layers)],
        "norm_w": arr(f"{enc_prefix}after_norm.weight"),
        "norm_b": arr(f"{enc_prefix}after_norm.bias"),
        "ada_conv_w": arr(f"{ada_prefix}conv.weight"),
        "ada_conv_b": arr(f"{ada_prefix}conv.bias"),
        "ada_l1": {"w": arr(f"{ada_prefix}linear1.weight"),
                   "b": arr(f"{ada_prefix}linear1.bias")},
        "ada_l2": {"w": arr(f"{ada_prefix}linear2.weight"),
                   "b": arr(f"{ada_prefix}linear2.bias")},
    }


def init_step_encoder_params(generator: torch.Generator, cfg: StepEncConfig,
                             device) -> dict:
    """Random parameters at ``cfg``'s widths (the JAX init's shapes and
    scales; the numbers come from ``generator``), float32."""
    g, dev = generator, device

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def lin(cin, cout, bias=True):
        p = {"w": normal((cout, cin), 1.0 / math.sqrt(cin))}
        if bias:
            p["b"] = torch.zeros((cout,), device=dev)
        return p

    D = cfg.d_model
    ones, zeros = (lambda: torch.ones((D,), device=dev),
                   lambda: torch.zeros((D,), device=dev))
    return {
        "conv1_w": normal((D, cfg.n_mels, 3), 0.05), "conv1_b": zeros(),
        "conv2_w": normal((D, D, 3), 0.02), "conv2_b": zeros(),
        "pos": normal((cfg.max_positions, D), 0.02),
        "layers": [{
            "q": lin(D, D), "k": lin(D, D, bias=False), "v": lin(D, D),
            "o": lin(D, D), "ln1_w": ones(), "ln1_b": zeros(),
            "fc1": lin(D, 4 * D), "fc2": lin(4 * D, D),
            "ln2_w": ones(), "ln2_b": zeros(),
        } for _ in range(cfg.layers)],
        "norm_w": ones(), "norm_b": zeros(),
        "ada_conv_w": normal((D, D, cfg.adapter_kernel), 0.02),
        "ada_conv_b": zeros(),
        "ada_l1": lin(D, cfg.adapter_hidden),
        "ada_l2": lin(cfg.adapter_hidden, cfg.llm_dim),
    }


def step_key_mask(T_in: int, T: int, valid_frames: int,
                  device) -> torch.Tensor:
    """(T, T) additive key mask of the encoder frames after the stride-2
    conv: mel frame 2j + (T_in + 1) % 2 stands for encoder frame j, which
    is a key iff that mel frame is < ``valid_frames``."""
    keep = torch.arange(T_in, device=device) < valid_frames
    keep = keep[(T_in + 1) % 2::2][:T]
    return torch.where(keep, 0.0, NEG)[None, :].expand(T, T)


def step_encode(params: dict, cfg: StepEncConfig, mel: torch.Tensor,
                valid_frames: int | None = None) -> torch.Tensor:
    """mel (B, n_mels, T_mel) -> encoder features (B, T_mel // 4, d_model):
    conv k3 s1 and conv k3 s2 (pad 1, exact GELU), learned positions, the
    pre-LN layers under the key-padding mask, an x2 average pool (floor),
    LayerNorm."""
    with full_float32():
        x = F.gelu(_conv1d(params["conv1_w"], params["conv1_b"],
                           mel.float(), 1, 1))
        x = F.gelu(_conv1d(params["conv2_w"], params["conv2_b"], x, 2, 1))
        x = x.transpose(1, 2)  # (B, T // 2, D)
        B, T, D = x.shape
        x = x + params["pos"][:T][None]
        mask = None
        if valid_frames is not None:
            mask = step_key_mask(mel.shape[-1], T, valid_frames, x.device)
        for lp in params["layers"]:
            x = _layer(lp, x, mask, cfg.heads)
        T2 = (T // 2) * 2
        x = x[:, :T2].reshape(B, T2 // 2, 2, D).mean(dim=2)
        return layer_norm(x, params["norm_w"], params["norm_b"])


def step_adaptor(params: dict, cfg: StepEncConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Encoder features (B, T, d_model) -> LLM embedding rows (B, T', llm):
    conv k7 s4 pad 1 with exact GELU, linear, ReLU, linear."""
    with full_float32():
        y = _conv1d(params["ada_conv_w"], params["ada_conv_b"],
                    x.transpose(1, 2), cfg.adapter_stride, 1)
        y = F.gelu(y).transpose(1, 2)
        y = F.relu(_linear(params["ada_l1"], y))
        return _linear(params["ada_l2"], y)
