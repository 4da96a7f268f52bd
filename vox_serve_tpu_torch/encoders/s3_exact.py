"""The S3 speech tokenizer v2 at 25 Hz (port of
vox_serve_tpu/encoders/s3_exact.py): CosyVoice2's voice-clone prompt
tokens.

The Whisper mel front end (``whisper_exact.py``), a conv stem (stride 2
twice: 100 -> 25 Hz), FSMN-attention transformer layers (a depthwise k31
memory conv over V added to the attention output; GPT-NeoX rotary with
duplicated cos/sin; no bias on K), and the FSQ head (a projection to 8
dims, tanh x 0.999, round + 1, a base-3 readout into 6561 tokens). The
published weights ship as ``speech_tokenizer_v2.onnx`` (tensors extracted
by ``onnx_reader``); torch-format conversions map through the same
loader. It runs eagerly on the model's device at preprocess time, as the
JAX package runs it outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norms import layer_norm
from ..weights import to_device


@dataclasses.dataclass(frozen=True)
class S3V2Config:
    n_mels: int = 128
    n_state: int = 1280
    heads: int = 20
    layers: int = 6
    stride: int = 2
    fsmn_kernel: int = 31
    fsq_dim: int = 8
    fsq_level: int = 3
    rope_dim: int = 64
    rope_max: int = 2048

    @property
    def vocab_size(self) -> int:
        return self.fsq_level ** self.fsq_dim


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def load_s3v2_params(sd: dict, cfg: S3V2Config, prefix: str = "", *,
                     device="cpu") -> dict:
    """Map the published tokenizer's tensors (numpy arrays from the ONNX
    reader, or torch tensors) onto ``init_s3v2_params``' tree, float32 on
    ``device``. Linear weights keep torch's ``(out, in)`` layout."""
    def arr(n):
        a = sd[prefix + n]
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    def lin(n, bias=True):
        p = {"w": arr(f"{n}.weight")}
        if bias and prefix + n + ".bias" in sd:
            p["b"] = arr(f"{n}.bias")
        return p

    layers = []
    for i in range(cfg.layers):
        pre = f"encoder.blocks.{i}"
        layers.append({
            "q": lin(f"{pre}.attn.query"),
            "k": lin(f"{pre}.attn.key", bias=False),
            "v": lin(f"{pre}.attn.value"),
            "o": lin(f"{pre}.attn.out"),
            "fsmn_w": arr(f"{pre}.attn.fsmn_block.weight"),  # (C, 1, K)
            "ln1_w": arr(f"{pre}.attn_ln.weight"),
            "ln1_b": arr(f"{pre}.attn_ln.bias"),
            "fc1": lin(f"{pre}.mlp.0"), "fc2": lin(f"{pre}.mlp.2"),
            "ln2_w": arr(f"{pre}.mlp_ln.weight"),
            "ln2_b": arr(f"{pre}.mlp_ln.bias"),
        })
    return {
        "conv1": {"w": arr("encoder.conv1.weight"),
                  "b": arr("encoder.conv1.bias")},
        "conv2": {"w": arr("encoder.conv2.weight"),
                  "b": arr("encoder.conv2.bias")},
        "layers": layers,
        "fsq_proj": lin("quantizer._codebook.project_down"),
    }


def init_s3v2_params(generator: torch.Generator, cfg: S3V2Config,
                     device) -> dict:
    """Random parameters (the JAX init's shapes and scales; the numbers
    come from ``generator``), float32."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def lin(cin, cout, bias=True):
        p = {"w": normal((cout, cin), 1.0 / math.sqrt(cin))}
        if bias:
            p["b"] = torch.zeros((cout,), device=device)
        return p

    C = cfg.n_state
    return {
        "conv1": {"w": normal((C, cfg.n_mels, 3), 0.05),
                  "b": torch.zeros((C,), device=device)},
        "conv2": {"w": normal((C, C, 3), 0.02),
                  "b": torch.zeros((C,), device=device)},
        "layers": [{
            "q": lin(C, C), "k": lin(C, C, bias=False), "v": lin(C, C),
            "o": lin(C, C),
            "fsmn_w": normal((C, 1, cfg.fsmn_kernel), 0.02),
            "ln1_w": torch.ones((C,), device=device),
            "ln1_b": torch.zeros((C,), device=device),
            "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C),
            "ln2_w": torch.ones((C,), device=device),
            "ln2_b": torch.zeros((C,), device=device),
        } for _ in range(cfg.layers)],
        "fsq_proj": lin(C, cfg.fsq_dim),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _lin(p, x):
    y = x @ p["w"].T
    if "b" in p:
        y = y + p["b"]
    return y


def _rope_tables(cfg: S3V2Config, T: int, device):
    """(cos, sin), each (T, rope_dim), computed on the host as the JAX
    package's numpy tables are."""
    dim = cfg.rope_dim
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    ang = np.outer(np.arange(T), freqs).astype(np.float32)
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)


def s3v2_project(params: dict, cfg: S3V2Config, mel: torch.Tensor
                 ) -> torch.Tensor:
    """mel (B, n_mels, T_mel) -> the FSQ head's pre-quantization values
    tanh(project_down(x)) x 0.999: (B, T_mel // 4, fsq_dim)."""
    x = F.gelu(F.conv1d(mel, params["conv1"]["w"], params["conv1"]["b"],
                        stride=cfg.stride, padding=1))
    x = F.gelu(F.conv1d(x, params["conv2"]["w"], params["conv2"]["b"],
                        stride=2, padding=1))
    x = x.transpose(1, 2)                                       # (B, T, C)

    B, T, C = x.shape
    H = cfg.heads
    hd = C // H
    cos, sin = _rope_tables(cfg, T, x.device)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    scale = hd ** -0.25
    pad_l = (cfg.fsmn_kernel - 1) // 2
    pad_r = cfg.fsmn_kernel - 1 - pad_l

    for lp in params["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps=1e-6)
        q = _lin(lp["q"], h).reshape(B, T, H, hd)
        k = _lin(lp["k"], h).reshape(B, T, H, hd)
        v = _lin(lp["v"], h).reshape(B, T, H, hd)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin

        # FSMN memory: a depthwise conv over V (before rotary), residual
        v_flat = v.reshape(B, T, C).transpose(1, 2)              # (B, C, T)
        mem = F.conv1d(F.pad(v_flat, (pad_l, pad_r)), lp["fsmn_w"],
                       groups=C)
        fsm_memory = mem.transpose(1, 2) + v.reshape(B, T, C)

        qh = (q * scale).transpose(1, 2)                        # (B, H, T, hd)
        kh = (k * scale).transpose(1, 2)
        a = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1) @ v.transpose(
            1, 2)
        x = x + _lin(lp["o"], a.transpose(1, 2).reshape(B, T, C)) \
            + fsm_memory

        h2 = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
        x = x + _lin(lp["fc2"], F.gelu(_lin(lp["fc1"], h2)))
    return torch.tanh(_lin(params["fsq_proj"], x)) * 0.9990000128746033


def s3v2_encode(params: dict, cfg: S3V2Config, mel: torch.Tensor
                ) -> torch.Tensor:
    """mel (B, n_mels, T_mel) -> speech tokens (B, T_mel // 4) int32: the
    FSQ readout sum((round(h) + 1) 3^i)."""
    hq = torch.round(s3v2_project(params, cfg, mel)) + 1.0
    powers = torch.tensor([float(cfg.fsq_level ** i)
                           for i in range(cfg.fsq_dim)], device=mel.device)
    return torch.sum(hq * powers, dim=-1).to(torch.int32)
