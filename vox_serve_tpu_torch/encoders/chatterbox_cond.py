"""Chatterbox's T3 conditioning encoder, weight-exact (port of
vox_serve_tpu/encoders/chatterbox_cond.py).

One AttentionBlock2 (LayerNorm on both operands, separate q/k/v, a residual
projection; 4 heads at C = 1024) applied twice: 32 learned queries
cross-attend over the prompt's speech embeddings, then the result attends
over itself. With the speaker projection (256 -> 1024) and the bias-free
emotion linear, the rows come out in the order [speaker, 32 prompt rows,
emotion] (``COND_LEN`` = 34). The weights live in ``t3_cfg.safetensors``
under ``cond_enc.*``; the default voice's speaker embedding, prompt tokens
and exaggeration ship in ``conds.pt``. Everything here is float32.
"""

from __future__ import annotations

import math

import torch

N_QUERY = 32
QUERY_DIM = 1024
HEADS = 4


def load_chatterbox_cond_params(sd: dict, prefix: str = "cond_enc.", *,
                                device="cpu") -> dict:
    """The ``cond_enc.*`` tensors of a T3 state dict, float32 on
    ``device`` (torch's ``(out, in)`` linear layout kept)."""
    def arr(n):
        return torch.as_tensor(sd[prefix + n]).to(device, torch.float32,
                                                  copy=True)

    p = {
        "spkr_w": arr("spkr_enc.weight"), "spkr_b": arr("spkr_enc.bias"),
        "emotion_w": arr("emotion_adv_fc.weight"),
        "query": arr("perceiver.pre_attention_query"),
        "norm_w": arr("perceiver.attn.norm.weight"),
        "norm_b": arr("perceiver.attn.norm.bias"),
    }
    for n in ("to_q", "to_k", "to_v", "proj_out"):
        p[n] = {"w": arr(f"perceiver.attn.{n}.weight"),
                "b": arr(f"perceiver.attn.{n}.bias")}
    return p


def init_chatterbox_cond_params(generator: torch.Generator, device,
                                channels: int = QUERY_DIM,
                                spk_dim: int = 256) -> dict:
    """Random parameters at the JAX init's shapes and scales (the numbers
    come from ``generator``), float32."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def lin(cin, cout):
        return {"w": normal((cout, cin), 0.05),
                "b": torch.zeros((cout,), device=device)}

    return {
        "spkr_w": normal((channels, spk_dim), 0.05),
        "spkr_b": torch.zeros((channels,), device=device),
        "emotion_w": normal((channels, 1), 0.05),
        "query": normal((1, N_QUERY, channels), 0.1),
        "norm_w": torch.ones((channels,), device=device),
        "norm_b": torch.zeros((channels,), device=device),
        "to_q": lin(channels, channels), "to_k": lin(channels, channels),
        "to_v": lin(channels, channels), "proj_out": lin(channels, channels),
    }


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].T + p["b"]


def _attn_block(p: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """AttentionBlock2: x1 + proj(MHA(q(norm x1), k(norm x2), v(norm
    x2)))."""
    def norm(x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * p["norm_w"] + p["norm_b"]

    B, T1, C = x1.shape
    hd = C // HEADS
    q = _lin(p["to_q"], norm(x1)).reshape(B, T1, HEADS, hd)
    k = _lin(p["to_k"], norm(x2)).reshape(B, -1, HEADS, hd)
    v = _lin(p["to_v"], norm(x2)).reshape(B, -1, HEADS, hd)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    a = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    return x1 + _lin(p["proj_out"], a.reshape(B, T1, C))


def chatterbox_perceiver(params: dict, h: torch.Tensor) -> torch.Tensor:
    """(B, T, C) prompt speech embeddings -> (B, 32, C): cross-attention
    of the learned queries over them, then self-attention."""
    query = params["query"].expand(h.shape[0], -1, -1)
    pre = _attn_block(params, query, h)
    return _attn_block(params, pre, pre)


def chatterbox_cond_encode(params: dict, speaker_emb: torch.Tensor,
                           prompt_speech_emb: torch.Tensor | None,
                           emotion_adv: float | torch.Tensor
                           ) -> torch.Tensor:
    """-> (1 + 32 + 1, C) conditioning rows [speaker, prompt, emotion]
    (the prompt rows only where ``prompt_speech_emb`` is given)."""
    dev = params["spkr_w"].device
    spk = torch.as_tensor(speaker_emb, dtype=torch.float32).to(dev)
    rows = [spk.reshape(1, -1) @ params["spkr_w"].T + params["spkr_b"]]
    if prompt_speech_emb is not None:
        emb = torch.as_tensor(prompt_speech_emb, dtype=torch.float32).to(dev)
        rows.append(chatterbox_perceiver(params, emb[None])[0])
    emo = torch.as_tensor(emotion_adv, dtype=torch.float32).to(dev)
    rows.append(emo.reshape(1, 1) @ params["emotion_w"].T)
    return torch.cat(rows, dim=0)
