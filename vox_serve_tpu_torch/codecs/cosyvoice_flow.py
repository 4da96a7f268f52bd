"""CosyVoice2 flow-matching token -> mel decoder (port of
vox_serve_tpu/codecs/cosyvoice_flow.py).

Token embedding and speaker affine -> the upsample conformer encoder (6
rel-pos conformer blocks at 25 Hz, x2 nearest upsample, 4 more blocks at
50 Hz) -> ``encoder_proj`` -> the conditional flow-matching solver: 10
cosine-schedule Euler steps with classifier-free guidance (rate 0.7), each
running the causal U-Net estimator (down block, 12 mid blocks, up block,
each a causal resnet and 4 transformer blocks) on a doubled batch
(conditional rows, then unconditional rows).

The parameter tree is the JAX package's (torch module names, ``(d_in,
d_out)`` linear weights, torch conv layouts), so the loaders are the same
walks of the published ``flow.pt`` state dict. Attention here is plain
PyTorch (matmul and softmax under an explicit boolean mask), as the JAX
package computes it outside any Pallas kernel. The constant tables (the
relative position encodings, the chunk masks, the time-embedding
frequencies) are made on the tensors' device by kernels, so the forward
runs inside a captured CUDA graph. The solver draws no random numbers:
the start noise is an argument (the model draws it once per window length
at build, ``models/flow_common.py``).

The private names ``_lin``, ``_mish``, ``_rel_pos_emb``,
``_conformer_layer`` and ``_encoder_forward`` are the ones later families
of the JAX package import from this module.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.backbone import _init_linear, linear
from ..ops.norms import layer_norm
from ..weights import to_device
from .layers import conv1d, init_conv1d


@dataclasses.dataclass(frozen=True)
class CosyFlowConfig:
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
    static_chunk_size: int = 25
    # estimator (CausalConditionalDecoder defaults)
    est_channels: int = 256
    est_head_dim: int = 64
    est_heads: int = 8
    est_n_blocks: int = 4
    est_mid_blocks: int = 12
    est_static_chunk: int = 50
    n_timesteps: int = 10
    cfg_rate: float = 0.7

    @property
    def upsample(self) -> int:  # model-facing: mel frames per token
        return self.token_mel_ratio

    @property
    def est_in(self) -> int:  # x + mu + spks + cond
        return self.mel_dim * 4

    @property
    def time_embed_dim(self) -> int:
        return self.est_channels * 4


# ---------------------------------------------------------------------------
# init (the tree mirrors the torch module names)
# ---------------------------------------------------------------------------


def _lin(generator, din, dout, device, bias=True):
    return _init_linear(generator, din, dout, torch.float32, device,
                        bias=bias)


def _ln(dim, device):
    return {"w": torch.ones((dim,), device=device),
            "b": torch.zeros((dim,), device=device)}


def init_cosy_flow(cfg: CosyFlowConfig, generator: torch.Generator,
                   device) -> dict:
    """Random parameters at ``cfg``'s widths (the JAX init's shapes and
    scales; the numbers come from ``generator``), float32."""
    g, dev = generator, device
    d = cfg.output_size

    def lin(din, dout, bias=True):
        return _lin(g, din, dout, dev, bias)

    def conv(cin, cout, k):
        return init_conv1d(g, cin, cout, k, dev)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    def conformer_layer():
        return {
            "self_attn": {
                "linear_q": lin(d, d), "linear_k": lin(d, d),
                "linear_v": lin(d, d), "linear_out": lin(d, d),
                "linear_pos": lin(d, d, bias=False),
                "pos_bias_u": normal((cfg.heads, d // cfg.heads), 0.02),
                "pos_bias_v": normal((cfg.heads, d // cfg.heads), 0.02),
            },
            "feed_forward": {"w_1": lin(d, cfg.linear_units),
                             "w_2": lin(cfg.linear_units, d)},
            "norm_mha": _ln(d, dev),
            "norm_ff": _ln(d, dev),
        }

    def causal_block(din, dout):
        return {"conv": conv(din, dout, 3), "norm": _ln(dout, dev)}

    def causal_resnet(din, dout):
        return {"mlp": lin(cfg.time_embed_dim, dout),
                "block1": causal_block(din, dout),
                "block2": causal_block(dout, dout),
                "res_conv": conv(din, dout, 1)}

    def est_transformer_block(dim):
        inner = cfg.est_heads * cfg.est_head_dim
        return {
            "norm1": _ln(dim, dev),
            "attn1": {"to_q": lin(dim, inner, bias=False),
                      "to_k": lin(dim, inner, bias=False),
                      "to_v": lin(dim, inner, bias=False),
                      "to_out": lin(inner, dim)},
            "norm3": _ln(dim, dev),
            "ff": {"proj": lin(dim, 4 * dim), "out": lin(4 * dim, dim)},
        }

    ch = cfg.est_channels
    est = {
        "time_mlp": {"linear_1": lin(cfg.est_in, cfg.time_embed_dim),
                     "linear_2": lin(cfg.time_embed_dim,
                                     cfg.time_embed_dim)},
        "down": [{
            "resnet": causal_resnet(cfg.est_in, ch),
            "blocks": [est_transformer_block(ch)
                       for _ in range(cfg.est_n_blocks)],
            "downsample": conv(ch, ch, 3),
        }],
        "mid": [{
            "resnet": causal_resnet(ch, ch),
            "blocks": [est_transformer_block(ch)
                       for _ in range(cfg.est_n_blocks)],
        } for _ in range(cfg.est_mid_blocks)],
        "up": [{
            "resnet": causal_resnet(ch * 2, ch),
            "blocks": [est_transformer_block(ch)
                       for _ in range(cfg.est_n_blocks)],
            "upsample": conv(ch, ch, 3),
        }],
        "final_block": causal_block(ch, ch),
        "final_proj": conv(ch, cfg.mel_dim, 1),
    }
    return {
        "input_embedding": normal((cfg.vocab_size, cfg.input_size), 0.02),
        "spk_embed_affine_layer": lin(cfg.spk_dim, cfg.mel_dim),
        "encoder": {
            "embed_out": lin(cfg.input_size, d),
            "embed_norm": _ln(d, dev),
            "up_embed_out": lin(cfg.input_size, d),
            "up_embed_norm": _ln(d, dev),
            "pre_lookahead": {"conv1": conv(d, d, cfg.pre_lookahead + 1),
                              "conv2": conv(d, d, 3)},
            "encoders": [conformer_layer() for _ in range(cfg.num_blocks)],
            "up_layer_conv": conv(d, d, 5),
            "up_encoders": [conformer_layer() for _ in range(cfg.up_blocks)],
            "after_norm": _ln(d, dev),
        },
        "encoder_proj": lin(d, cfg.mel_dim),
        "estimator": est,
    }


# ---------------------------------------------------------------------------
# weight mapping
# ---------------------------------------------------------------------------


def _state_mapper(sd: dict, prefix: str, device):
    """(arr, lin, conv, ln) over a state dict of torch tensors or numpy
    arrays: each tensor copied once to ``device`` as float32, linear
    weights transposed to ``(d_in, d_out)`` there."""
    def t(name):
        a = sd[prefix + name]
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))

    def arr(name):
        return to_device(t(name), device, torch.float32)

    def lin(name, bias=True):
        p = {"w": to_device(t(f"{name}.weight"), device, torch.float32,
                            transpose=True)}
        if bias and prefix + name + ".bias" in sd:
            p["b"] = arr(f"{name}.bias")
        return p

    def conv(name):
        p = {"w": arr(f"{name}.weight")}
        if prefix + name + ".bias" in sd:
            p["b"] = arr(f"{name}.bias")
        return p

    def ln(name):
        return {"w": arr(f"{name}.weight"), "b": arr(f"{name}.bias")}

    return arr, lin, conv, ln


def load_cosy_flow_params(sd: dict, cfg: CosyFlowConfig, prefix: str = "",
                          *, device="cpu") -> dict:
    """Map the published flow checkpoint (CosyVoice2 ``flow.pt`` =
    ``CausalMaskedDiffWithXvec.state_dict()``; Chatterbox's s3gen holds
    the same module under ``flow.``) onto ``init_cosy_flow``'s tree."""
    _, lin, conv, ln = _state_mapper(sd, prefix, device)

    def causal_block(pre):
        return {"conv": conv(f"{pre}.block.0"), "norm": ln(f"{pre}.block.2")}

    def causal_resnet(pre):
        return {"mlp": lin(f"{pre}.mlp.1"),
                "block1": causal_block(f"{pre}.block1"),
                "block2": causal_block(f"{pre}.block2"),
                "res_conv": conv(f"{pre}.res_conv")}

    def est_transformer_block(pre):
        return {
            "norm1": ln(f"{pre}.norm1"),
            "attn1": {"to_q": lin(f"{pre}.attn1.to_q", bias=False),
                      "to_k": lin(f"{pre}.attn1.to_k", bias=False),
                      "to_v": lin(f"{pre}.attn1.to_v", bias=False),
                      "to_out": lin(f"{pre}.attn1.to_out.0")},
            "norm3": ln(f"{pre}.norm3"),
            "ff": {"proj": lin(f"{pre}.ff.net.0.proj"),
                   "out": lin(f"{pre}.ff.net.2")},
        }

    e = "decoder.estimator"
    est = {
        "time_mlp": {"linear_1": lin(f"{e}.time_mlp.linear_1"),
                     "linear_2": lin(f"{e}.time_mlp.linear_2")},
        "down": [{
            "resnet": causal_resnet(f"{e}.down_blocks.0.0"),
            "blocks": [est_transformer_block(f"{e}.down_blocks.0.1.{j}")
                       for j in range(cfg.est_n_blocks)],
            "downsample": conv(f"{e}.down_blocks.0.2"),
        }],
        "mid": [{
            "resnet": causal_resnet(f"{e}.mid_blocks.{i}.0"),
            "blocks": [est_transformer_block(f"{e}.mid_blocks.{i}.1.{j}")
                       for j in range(cfg.est_n_blocks)],
        } for i in range(cfg.est_mid_blocks)],
        "up": [{
            "resnet": causal_resnet(f"{e}.up_blocks.0.0"),
            "blocks": [est_transformer_block(f"{e}.up_blocks.0.1.{j}")
                       for j in range(cfg.est_n_blocks)],
            "upsample": conv(f"{e}.up_blocks.0.2"),
        }],
        "final_block": causal_block(f"{e}.final_block"),
        "final_proj": conv(f"{e}.final_proj"),
    }
    return {**load_cosy_encoder_section(sd, cfg, prefix, device=device),
            "estimator": est}


def load_cosy_encoder_section(sd: dict, cfg: CosyFlowConfig,
                              prefix: str = "", *, device="cpu") -> dict:
    """The non-estimator parts (input embedding, speaker affine, upsample
    conformer encoder, ``encoder_proj``): one key layout in CosyVoice2's
    ``flow.pt``, Chatterbox's s3gen and Step-Audio 2's token2wav."""
    arr, lin, conv, ln = _state_mapper(sd, prefix, device)

    def conformer_layer(pre):
        a = f"{pre}.self_attn"
        return {
            "self_attn": {
                "linear_q": lin(f"{a}.linear_q"),
                "linear_k": lin(f"{a}.linear_k"),
                "linear_v": lin(f"{a}.linear_v"),
                "linear_out": lin(f"{a}.linear_out"),
                "linear_pos": lin(f"{a}.linear_pos", bias=False),
                "pos_bias_u": arr(f"{a}.pos_bias_u"),
                "pos_bias_v": arr(f"{a}.pos_bias_v"),
            },
            "feed_forward": {"w_1": lin(f"{pre}.feed_forward.w_1"),
                             "w_2": lin(f"{pre}.feed_forward.w_2")},
            "norm_mha": ln(f"{pre}.norm_mha"),
            "norm_ff": ln(f"{pre}.norm_ff"),
        }

    enc = "encoder"
    return {
        "input_embedding": arr("input_embedding.weight"),
        "spk_embed_affine_layer": lin("spk_embed_affine_layer"),
        "encoder": {
            "embed_out": lin(f"{enc}.embed.out.0"),
            "embed_norm": ln(f"{enc}.embed.out.1"),
            "up_embed_out": lin(f"{enc}.up_embed.out.0"),
            "up_embed_norm": ln(f"{enc}.up_embed.out.1"),
            "pre_lookahead": {
                "conv1": conv(f"{enc}.pre_lookahead_layer.conv1"),
                "conv2": conv(f"{enc}.pre_lookahead_layer.conv2"),
            },
            "encoders": [conformer_layer(f"{enc}.encoders.{i}")
                         for i in range(cfg.num_blocks)],
            "up_layer_conv": conv(f"{enc}.up_layer.conv"),
            "up_encoders": [conformer_layer(f"{enc}.up_encoders.{i}")
                            for i in range(cfg.up_blocks)],
            "after_norm": ln(f"{enc}.after_norm"),
        },
        "encoder_proj": lin("encoder_proj"),
    }


# ---------------------------------------------------------------------------
# conformer encoder
# ---------------------------------------------------------------------------


def _rel_pos_emb(d: int, T: int, device) -> torch.Tensor:
    """Espnet relative positional encoding for length T: rows are relative
    distances T-1 .. -(T-1) with interleaved sin/cos, computed in float64
    as the JAX package's numpy table is, then float32: (1, 2T-1, d)."""
    f64 = torch.float64
    rel = torch.arange(T - 1, -T, -1, dtype=f64, device=device)
    div = torch.exp(torch.arange(0, d, 2, dtype=f64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.stack([torch.sin(rel[:, None] * div[None, :]),
                      torch.cos(rel.abs()[:, None] * div[None, :])], dim=-1)
    return pe.reshape(2 * T - 1, d).float()[None]


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T): the espnet rel-shift trick."""
    B, H, T, _ = x.shape
    xp = F.pad(x, (1, 0)).reshape(B, H, 2 * T, T)
    return xp[:, :, 1:].reshape(B, H, T, 2 * T - 1)[:, :, :, :T]


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """Softmax over the last axis with the masked-out scores at the
    float32 minimum (a fully masked row stays uniform, as in JAX)."""
    neg = torch.finfo(torch.float32).min
    return torch.softmax(scores.masked_fill(~mask, neg), dim=-1)


def _rel_attention(p: dict, cfg: CosyFlowConfig, x: torch.Tensor,
                   pos_emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RelPositionMultiHeadedAttention. x (B, T, d); pos_emb (1, 2T-1, d);
    mask (B, T, T) bool."""
    B, T, d = x.shape
    H = cfg.heads
    dk = d // H
    q = linear(p["linear_q"], x).reshape(B, T, H, dk)
    k = linear(p["linear_k"], x).reshape(B, T, H, dk).transpose(1, 2)
    v = linear(p["linear_v"], x).reshape(B, T, H, dk).transpose(1, 2)
    pe = linear(p["linear_pos"], pos_emb).reshape(1, -1, H, dk
                                                  ).transpose(1, 2)
    q_u = (q + p["pos_bias_u"][None, None].to(q.dtype)).transpose(1, 2)
    q_v = (q + p["pos_bias_v"][None, None].to(q.dtype)).transpose(1, 2)
    ac = q_u @ k.transpose(-1, -2)                            # (B, H, T, T)
    bd = _rel_shift(q_v @ pe.transpose(-1, -2))               # (B, H, T, T)
    scores = (ac + bd) / math.sqrt(dk)
    m = mask[:, None]
    attn = _masked_softmax(scores, m).masked_fill(~m, 0.0)
    out = (attn @ v).transpose(1, 2).reshape(B, T, d)
    return linear(p["linear_out"], out)


def _conformer_layer(p: dict, cfg: CosyFlowConfig, x, pos_emb, mask):
    h = layer_norm(x, p["norm_mha"]["w"], p["norm_mha"]["b"], eps=1e-12)
    x = x + _rel_attention(p["self_attn"], cfg, h, pos_emb, mask)
    h = layer_norm(x, p["norm_ff"]["w"], p["norm_ff"]["b"], eps=1e-12)
    ff = linear(p["feed_forward"]["w_2"],
                F.silu(linear(p["feed_forward"]["w_1"], h)))
    return x + ff


def _chunk_mask(T: int, chunk: int, device) -> torch.Tensor:
    """Block-causal streaming mask (subsequent_chunk_mask with all left
    chunks): (T, T) bool."""
    pos = torch.arange(T, device=device)
    block = (pos // chunk + 1) * chunk
    return pos[None, :] < block[:, None]


def _attn_mask(valid: torch.Tensor, chunk: int, streaming: bool
               ) -> torch.Tensor:
    """(B, T) valid keys -> (B, T, T) bool: the key mask, and the chunk
    mask when streaming."""
    B, T = valid.shape
    km = valid[:, None, :]
    if streaming:
        return km & _chunk_mask(T, chunk, valid.device)[None]
    return km.expand(B, T, T)


def _encoder_forward(params: dict, cfg: CosyFlowConfig,
                     token_emb: torch.Tensor, valid: torch.Tensor,
                     streaming: bool, context: int = 0) -> torch.Tensor:
    """token_emb (B, T, input_size), valid (B, T) bool -> (B, 2(T -
    context), d). ``context=0`` zero-pads the pre-lookahead conv's
    lookahead; ``context=k`` treats the last k tokens as real lookahead
    (they feed conv1 and are dropped before the attention stack)."""
    enc = params["encoder"]
    T = token_emb.shape[1]
    d = cfg.output_size

    x = linear(enc["embed_out"], token_emb)
    x = layer_norm(x, enc["embed_norm"]["w"], enc["embed_norm"]["b"],
                   eps=1e-5)
    x = x * math.sqrt(d)

    # pre-lookahead: conv1 sees `pre_lookahead` future tokens, conv2 is
    # causal, a residual on the body
    pl = enc["pre_lookahead"]
    y = F.pad(x.transpose(1, 2), (0, cfg.pre_lookahead - context))
    y = F.leaky_relu(conv1d(pl["conv1"], y), 0.01)
    y = conv1d(pl["conv2"], F.pad(y, (2, 0)))
    T = T - context
    x = x[:, :T] + y.transpose(1, 2).to(x.dtype)
    valid = valid[:, :T]

    pos_emb = _rel_pos_emb(d, T, x.device)
    mask = _attn_mask(valid, cfg.static_chunk_size, streaming)
    for lp in enc["encoders"]:
        x = _conformer_layer(lp, cfg, x, pos_emb, mask)

    # x2 nearest upsample + conv k=5 left-padded by 4 (Upsample1D)
    xt = torch.repeat_interleave(x.transpose(1, 2), 2, dim=-1)
    xt = conv1d(enc["up_layer_conv"], F.pad(xt, (4, 0)))
    x = xt.transpose(1, 2)                                     # (B, 2T, d)

    x = linear(enc["up_embed_out"], x)
    x = layer_norm(x, enc["up_embed_norm"]["w"], enc["up_embed_norm"]["b"],
                   eps=1e-5)
    x = x * math.sqrt(d)
    pos_emb2 = _rel_pos_emb(d, 2 * T, x.device)
    mask2 = _attn_mask(torch.repeat_interleave(valid, 2, dim=-1),
                       cfg.static_chunk_size * 2, streaming)
    for lp in enc["up_encoders"]:
        x = _conformer_layer(lp, cfg, x, pos_emb2, mask2)
    return layer_norm(x, enc["after_norm"]["w"], enc["after_norm"]["b"],
                      eps=1e-5)


# ---------------------------------------------------------------------------
# estimator (causal U-Net)
# ---------------------------------------------------------------------------


def _causal_conv3(p, x):
    return conv1d(p, F.pad(x, (2, 0)))


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _causal_block(p, x, mask):
    y = _causal_conv3(p["conv"], x * mask)
    y = layer_norm(y.transpose(1, 2), p["norm"]["w"], p["norm"]["b"],
                   eps=1e-5).transpose(1, 2)
    return _mish(y) * mask


def _resnet(p, x, mask, t_emb):
    """CausalResnetBlock1D."""
    h = _causal_block(p["block1"], x, mask)
    h = h + linear(p["mlp"], _mish(t_emb))[:, :, None]
    h = _causal_block(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


def _est_attention(p, cfg: CosyFlowConfig, x, mask):
    """diffusers Attention. x (B, T, C); mask (B, T, T) bool."""
    B, T, _ = x.shape
    q, k, v = (linear(p[n], x) for n in ("to_q", "to_k", "to_v"))
    inner = q.shape[-1]
    H = cfg.est_heads
    hd = inner // H
    q, k, v = (a.reshape(B, T, H, hd).transpose(1, 2) for a in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    attn = _masked_softmax(scores, mask[:, None])
    out = (attn @ v).transpose(1, 2).reshape(B, T, inner)
    return linear(p["to_out"], out)


def _est_transformer_block(p, cfg: CosyFlowConfig, x, mask):
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps=1e-5)
    x = x + _est_attention(p["attn1"], cfg, h, mask)
    h = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=1e-5)
    ff = linear(p["ff"]["out"], F.gelu(linear(p["ff"]["proj"], h)))
    return x + ff


def _blocks(blocks, cfg, h, am):
    ht = h.transpose(1, 2)
    for bp in blocks:
        ht = _est_transformer_block(bp, cfg, ht, am)
    return ht.transpose(1, 2)


def _estimator_forward(est: dict, cfg: CosyFlowConfig, x, mask, mu,
                       t_scalar, spks, cond, streaming: bool):
    """ConditionalDecoder.forward. x/mu/cond (B, mel, T); mask (B, 1, T);
    t_scalar (B,); spks (B, mel). The down and up blocks keep the length
    (their resampling convs have stride 1), so one mask serves every
    level."""
    B, _, T = x.shape
    half = cfg.est_in // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=x.device,
                                   dtype=torch.float32) * -emb)
    te = 1000.0 * t_scalar[:, None] * freqs[None]
    te = torch.cat([torch.sin(te), torch.cos(te)], dim=-1)
    t_emb = linear(est["time_mlp"]["linear_2"],
                   F.silu(linear(est["time_mlp"]["linear_1"], te)))

    h = torch.cat([x, mu, spks[:, :, None].expand(B, spks.shape[1], T),
                   cond], dim=1)                               # (B, 4 mel, T)
    am = _attn_mask(mask[:, 0] > 0, cfg.est_static_chunk, streaming)

    d0 = est["down"][0]
    h = _resnet(d0["resnet"], h, mask, t_emb)
    skip = h = _blocks(d0["blocks"], cfg, h, am)
    h = _causal_conv3(d0["downsample"], h * mask)

    for mp in est["mid"]:
        h = _resnet(mp["resnet"], h, mask, t_emb)
        h = _blocks(mp["blocks"], cfg, h, am)

    u0 = est["up"][0]
    h = torch.cat([h, skip], dim=1)
    h = _resnet(u0["resnet"], h, mask, t_emb)
    h = _blocks(u0["blocks"], cfg, h, am)
    h = _causal_conv3(u0["upsample"], h * mask)

    h = _causal_block(est["final_block"], h, mask)
    return conv1d(est["final_proj"], h * mask) * mask


# ---------------------------------------------------------------------------
# CFM Euler solver + top level
# ---------------------------------------------------------------------------


def cfm_timesteps(n: int) -> list[float]:
    """The cosine schedule 1 - cos(t pi / 2) over n + 1 points of [0, 1],
    in float32 as JAX computes it (host floats)."""
    ts = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    ts = np.float32(1.0) - np.cos(ts * np.float32(0.5 * np.pi),
                                  dtype=np.float32)
    return [float(t) for t in ts]


def cosy_flow_forward(params: dict, cfg: CosyFlowConfig,
                      tokens: torch.Tensor, valid: torch.Tensor,
                      spk: torch.Tensor, conds: torch.Tensor, *,
                      noise: torch.Tensor,
                      streaming: bool = True) -> torch.Tensor:
    """tokens (B, T) int; valid (B, T) bool; spk (B, spk_dim) x-vector;
    conds (B, 2T, mel) prompt-mel anchor rows (zeros elsewhere); noise
    (1, mel, 2T), the solver's start, the same for every row -> mel (B,
    mel, 2T).

    CausalMaskedDiffWithXvec.forward (finalize) + the 10-step cosine Euler
    solver with classifier-free guidance."""
    B, T = tokens.shape
    spk_n = spk / torch.clamp(torch.linalg.vector_norm(spk, dim=1,
                                                       keepdim=True),
                              min=1e-12)
    spk_e = linear(params["spk_embed_affine_layer"], spk_n)    # (B, mel)

    emb = params["input_embedding"][
        torch.clamp(tokens.long(), 0, cfg.vocab_size - 1)]
    emb = emb * valid[:, :, None].to(emb.dtype)
    h = _encoder_forward(params, cfg, emb, valid, streaming)   # (B, 2T, d)
    mu = linear(params["encoder_proj"], h).transpose(1, 2)     # (B, mel, 2T)

    mask = torch.repeat_interleave(valid, 2, dim=-1)[:, None, :].to(mu.dtype)
    cond = conds.transpose(1, 2).to(mu.dtype)                  # (B, mel, 2T)
    x = noise.to(mu.dtype).expand(B, cfg.mel_dim, 2 * T)

    ts = cfm_timesteps(cfg.n_timesteps)
    # the unconditional half of the doubled batch: no mu, speaker or cond
    mu_in = torch.cat([mu, torch.zeros_like(mu)])
    spk_in = torch.cat([spk_e, torch.zeros_like(spk_e)])
    cond_in = torch.cat([cond, torch.zeros_like(cond)])
    mask_in = torch.cat([mask, mask])
    for step in range(1, cfg.n_timesteps + 1):
        t, dt = ts[step - 1], ts[step] - ts[step - 1]
        t_in = torch.full((2 * B,), t, dtype=mu.dtype, device=mu.device)
        dphi = _estimator_forward(params["estimator"], cfg,
                                  torch.cat([x, x]), mask_in, mu_in, t_in,
                                  spk_in, cond_in, streaming)
        cond_d, uncond_d = dphi[:B], dphi[B:]
        dphi = (1.0 + cfg.cfg_rate) * cond_d - cfg.cfg_rate * uncond_d
        x = x + dt * dphi
    return x
