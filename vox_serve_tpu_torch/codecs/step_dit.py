"""Step-Audio 2 flow-matching token -> mel decoder with its DiT estimator
(port of vox_serve_tpu/codecs/step_dit.py).

Token embedding and speaker affine -> the upsample conformer encoder
(CosyVoice2's: the same modules and weight names, ``cosyvoice_flow.
_encoder_forward``), whose last ``context`` tokens are real lookahead for
the pre-lookahead conv only -> ``encoder_proj`` -> the conditional
flow-matching solver: 10 cosine-schedule Euler steps with classifier-free
guidance (rate 0.7) on a doubled batch (conditional rows, then
unconditional rows with zero mu, speaker and cond), each running the DiT
estimator: a sinusoidal timestep embedding ([cos, sin], 128 frequencies,
scale 1000) through a SiLU MLP, an input projection of [x, mu, spk, cond],
then 16 adaLN-Zero blocks (attention with per-head q/k LayerNorms, a
causal conv block, a tanh-GELU MLP) and a modulated final linear.

Attention inside a window is full and bidirectional, with no mask. The
parameter tree is the JAX package's (torch module names, ``(d_in,
d_out)`` linear weights, torch conv layouts), so the loader is the same
walk of the published ``token2wav/flow.pt``. The constant tables (the
sinusoid frequencies, the encoder's relative position encodings) are made
on the tensors' device by kernels and the timesteps are host floats, so
the forward runs inside a captured CUDA graph. The solver draws no random
numbers: the start noise is an argument (the model draws it once per
window length at build). Plain PyTorch in float32, as the JAX package
computes it in XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import linear
from ..ops.norms import layer_norm
from .cosyvoice_flow import (CosyFlowConfig, _encoder_forward, _lin, _ln,
                             _mish, _state_mapper, cfm_timesteps,
                             init_cosy_flow, load_cosy_encoder_section)
from .layers import conv1d, init_conv1d


@dataclasses.dataclass(frozen=True)
class StepFlowConfig:
    input_size: int = 512
    output_size: int = 512
    heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    up_blocks: int = 4
    vocab_size: int = 6561
    spk_dim: int = 192
    mel_dim: int = 80
    token_mel_ratio: int = 2
    pre_lookahead: int = 3
    # DiT estimator
    dit_depth: int = 16
    dit_hidden: int = 512
    dit_heads: int = 8
    dit_head_dim: int = 64
    dit_mlp_ratio: float = 4.0
    n_timesteps: int = 10
    cfg_rate: float = 0.7

    @property
    def upsample(self) -> int:
        return self.token_mel_ratio

    @property
    def est_in(self) -> int:  # x + mu + spks + cond
        return self.mel_dim * 4

    def encoder_cfg(self) -> CosyFlowConfig:
        return CosyFlowConfig(
            input_size=self.input_size, output_size=self.output_size,
            heads=self.heads, linear_units=self.linear_units,
            num_blocks=self.num_blocks, up_blocks=self.up_blocks,
            vocab_size=self.vocab_size, spk_dim=self.spk_dim,
            mel_dim=self.mel_dim, pre_lookahead=self.pre_lookahead)


# ---------------------------------------------------------------------------
# init / load
# ---------------------------------------------------------------------------

_ENCODER_SECTION = ("input_embedding", "spk_embed_affine_layer", "encoder",
                    "encoder_proj")


def init_step_flow(cfg: StepFlowConfig, generator: torch.Generator,
                   device) -> dict:
    """Random parameters at ``cfg``'s widths (the JAX init's shapes and
    scales; the numbers come from ``generator``), float32: the Cosy
    encoder section, then the DiT."""
    g, dev = generator, device
    base = init_cosy_flow(cfg.encoder_cfg(), g, dev)

    def lin(din, dout):
        return _lin(g, din, dout, dev)

    hs, hd = cfg.dit_hidden, cfg.dit_head_dim
    inner = cfg.dit_heads * hd
    mlp_h = int(hs * cfg.dit_mlp_ratio)

    def dit_block():
        return {
            "attn": {"to_q": lin(hs, inner), "to_k": lin(hs, inner),
                     "to_v": lin(hs, inner), "q_norm": _ln(hd, dev),
                     "k_norm": _ln(hd, dev), "proj": lin(inner, hs)},
            "mlp": {"fc1": lin(hs, mlp_h), "fc2": lin(mlp_h, hs)},
            "conv": {"conv1": init_conv1d(g, hs, hs, 3, dev),
                     "norm": _ln(hs, dev),
                     "conv2": init_conv1d(g, hs, hs, 3, dev)},
            "adaln": lin(hs, 9 * hs),
        }

    est = {
        "t_mlp1": lin(256, hs),
        "t_mlp2": lin(hs, hs),
        "in_proj": lin(cfg.est_in, hs),
        "blocks": [dit_block() for _ in range(cfg.dit_depth)],
        "final_adaln": lin(hs, 2 * hs),
        "final_linear": lin(hs, cfg.mel_dim),
    }
    return {**{k: base[k] for k in _ENCODER_SECTION}, "estimator": est}


def load_step_flow_params(sd: dict, cfg: StepFlowConfig, prefix: str = "",
                          *, device="cpu") -> dict:
    """Map ``token2wav/flow.pt`` (Step's ``CausalMaskedDiffWithXvec.
    state_dict()``: the encoder keys are CosyVoice2's, the DiT lives under
    ``decoder.estimator.*``) onto ``init_step_flow``'s tree."""
    base = load_cosy_encoder_section(sd, cfg.encoder_cfg(), prefix,
                                     device=device)
    _, lin, conv, ln = _state_mapper(sd, prefix, device)

    e = "decoder.estimator"
    blocks = []
    for i in range(cfg.dit_depth):
        pre = f"{e}.blocks.{i}"
        blocks.append({
            "attn": {"to_q": lin(f"{pre}.attn.to_q"),
                     "to_k": lin(f"{pre}.attn.to_k"),
                     "to_v": lin(f"{pre}.attn.to_v"),
                     "q_norm": ln(f"{pre}.attn.q_norm"),
                     "k_norm": ln(f"{pre}.attn.k_norm"),
                     "proj": lin(f"{pre}.attn.proj")},
            "mlp": {"fc1": lin(f"{pre}.mlp.fc1"),
                    "fc2": lin(f"{pre}.mlp.fc2")},
            "conv": {"conv1": conv(f"{pre}.conv.block.1"),
                     "norm": ln(f"{pre}.conv.block.3"),
                     "conv2": conv(f"{pre}.conv.block.6")},
            "adaln": lin(f"{pre}.adaLN_modulation.1"),
        })
    est = {
        "t_mlp1": lin(f"{e}.t_embedder.mlp.0"),
        "t_mlp2": lin(f"{e}.t_embedder.mlp.2"),
        "in_proj": lin(f"{e}.in_proj"),
        "blocks": blocks,
        "final_adaln": lin(f"{e}.final_layer.adaLN_modulation.1"),
        "final_linear": lin(f"{e}.final_layer.linear"),
    }
    return {**base, "estimator": est}


# ---------------------------------------------------------------------------
# DiT estimator
# ---------------------------------------------------------------------------


def _dit_attention(p: dict, cfg: StepFlowConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """DiTAttention: q/k/v biases, per-head q and k LayerNorms (eps 1e-5,
    affine), full bidirectional attention. x (B, T, hs)."""
    B, T, _ = x.shape
    H, hd = cfg.dit_heads, cfg.dit_head_dim
    q, k, v = (linear(p[n], x).reshape(B, T, H, hd)
               for n in ("to_q", "to_k", "to_v"))
    q = layer_norm(q, p["q_norm"]["w"], p["q_norm"]["b"], eps=1e-5)
    k = layer_norm(k, p["k_norm"]["w"], p["k_norm"]["b"], eps=1e-5)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, T, hd)
    attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B, T, H * hd)
    return linear(p["proj"], out)


def _plain_ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without an affine (the adaLN blocks' norm)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _dit_conv_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """[causal conv k3, LayerNorm (eps 1e-5), Mish, causal conv k3] on (B,
    T, C); each conv left-padded by 2."""
    y = conv1d(p["conv1"], F.pad(x.transpose(1, 2), (2, 0)))
    y = layer_norm(y.transpose(1, 2), p["norm"]["w"], p["norm"]["b"],
                   eps=1e-5)
    y = conv1d(p["conv2"], F.pad(_mish(y).transpose(1, 2), (2, 0)))
    return y.transpose(1, 2)


def _timestep_embedding(t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 256): [cos, sin] of 1000 t over 128 frequencies."""
    half = 128
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device,
                                     dtype=torch.float32) / half)
    args = (1000.0 * t)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dit_forward(est: dict, cfg: StepFlowConfig, x, mu, t_scalar, spks,
                 cond) -> torch.Tensor:
    """DiT.forward_chunk without caches (full window attention). x / mu /
    cond (B, mel, T); spks (B, mel); t_scalar (B,) -> (B, mel, T)."""
    B, _, T = x.shape
    c = linear(est["t_mlp2"], F.silu(linear(est["t_mlp1"],
                                            _timestep_embedding(t_scalar))))
    c = F.silu(c)[:, None, :]                                 # (B, 1, hs)

    h = torch.cat([x, mu, spks[:, :, None].expand(B, spks.shape[1], T),
                   cond], dim=1)                              # (B, 4 mel, T)
    h = linear(est["in_proj"], h.transpose(1, 2))             # (B, T, hs)

    for bp in est["blocks"]:
        # adaLN-Zero: shift / scale / gate for attention, MLP, conv
        (sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp, sh_conv, sc_conv,
         g_conv) = linear(bp["adaln"], c).chunk(9, dim=-1)
        h = h + g_msa * _dit_attention(
            bp["attn"], cfg, _plain_ln(h) * (1 + sc_msa) + sh_msa)
        h = h + g_conv * _dit_conv_block(
            bp["conv"], _plain_ln(h) * (1 + sc_conv) + sh_conv)
        mlp_in = _plain_ln(h) * (1 + sc_mlp) + sh_mlp
        h = h + g_mlp * linear(
            bp["mlp"]["fc2"],
            F.gelu(linear(bp["mlp"]["fc1"], mlp_in), approximate="tanh"))

    sh, sc = linear(est["final_adaln"], c).chunk(2, dim=-1)
    h = _plain_ln(h) * (1 + sc) + sh
    return linear(est["final_linear"], h).transpose(1, 2)     # (B, mel, T)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def step_flow_forward(params: dict, cfg: StepFlowConfig,
                      tokens: torch.Tensor, valid: torch.Tensor,
                      spk: torch.Tensor, conds: torch.Tensor, *,
                      noise: torch.Tensor, context: int = 0
                      ) -> torch.Tensor:
    """tokens (B, T) int; valid (B, T) bool; spk (B, spk_dim); conds (B,
    >= 2 (T - context), mel); noise (1 or B, mel, 2 (T - context)), the
    solver's start -> mel (B, mel, 2 (T - context)).

    Step's ``CausalMaskedDiffWithXvec.inference_chunk`` with full-window
    attention: stateless per window, the last ``context`` tokens feed the
    pre-lookahead conv only."""
    B, T = tokens.shape
    spk_n = spk / torch.clamp(torch.linalg.vector_norm(spk, dim=1,
                                                       keepdim=True),
                              min=1e-12)
    spk_e = linear(params["spk_embed_affine_layer"], spk_n)   # (B, mel)

    emb = params["input_embedding"][
        torch.clamp(tokens.long(), 0, cfg.vocab_size - 1)]
    emb = emb * valid[:, :, None].to(emb.dtype)
    h = _encoder_forward(params, cfg.encoder_cfg(), emb, valid,
                         streaming=False, context=context)
    mu = linear(params["encoder_proj"], h).transpose(1, 2)     # (B, mel, T2)

    T2 = mu.shape[-1]
    cond = conds.transpose(1, 2).to(mu.dtype)[:, :, :T2]
    x = noise.to(mu.dtype).expand(B, cfg.mel_dim, T2)

    ts = cfm_timesteps(cfg.n_timesteps)
    # the unconditional half of the doubled batch: no mu, speaker or cond
    mu_in = torch.cat([mu, torch.zeros_like(mu)])
    spk_in = torch.cat([spk_e, torch.zeros_like(spk_e)])
    cond_in = torch.cat([cond, torch.zeros_like(cond)])
    for step in range(1, cfg.n_timesteps + 1):
        t, dt = ts[step - 1], ts[step] - ts[step - 1]
        t_in = torch.full((2 * B,), t, dtype=mu.dtype, device=mu.device)
        dphi = _dit_forward(params["estimator"], cfg, torch.cat([x, x]),
                            mu_in, t_in, spk_in, cond_in)
        dphi = (1.0 + cfg.cfg_rate) * dphi[:B] - cfg.cfg_rate * dphi[B:]
        x = x + dt * dphi
    return x
