"""GLM-4-Voice flow-matching token -> mel decoder (port of
vox_serve_tpu/codecs/glm_flow.py).

Token embedding -> the block conformer encoder (6 rel-pos conformer blocks
whose attention mask is causal OR the same 10-token block) ->
``encoder_proj`` -> the interpolate regulator (a nearest resize to the
22.05 kHz mel rate, 172 frames per 25 tokens, then conv / GroupNorm(1) /
Mish) -> the conditional flow-matching solver: 10 cosine-schedule Euler
steps with classifier-free guidance (rate 0.7), each running the
non-causal U-Net estimator (two levels of 256 channels, a stride-2 conv
down, 12 mid blocks, a ``ConvTranspose1d(4, 2, 1)`` up with the skip crop,
GroupNorm(8) resnets and 4 transformer blocks per level) on a doubled
batch (conditional rows, then unconditional rows).

The conformer machinery (``_conformer_layer``, ``_rel_pos_emb``, ``_lin``,
``_mish``) is the CosyVoice2 flow's (``cosyvoice_flow.py``): the same
espnet modules. The parameter tree is the JAX package's (torch module
names, ``(d_in, d_out)`` linear weights, torch conv layouts), so the loader
is the same walk of the published ``flow.pt``. The constant tables (the
block mask, the relative position encodings, the regulator's nearest
index, the time-embedding frequencies) are made on the tensors' device by
kernels, so the forward runs inside a captured CUDA graph. The solver draws
no random numbers: the start noise is an argument (the model draws it once
per window length at build).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.backbone import linear
from ..ops.norms import layer_norm
from .cosyvoice_flow import (_conformer_layer, _lin, _ln, _mish,
                             _rel_pos_emb, _state_mapper, cfm_timesteps)
from .layers import (conv1d, conv_transpose1d, init_conv1d,
                     init_conv_transpose1d)


@dataclasses.dataclass(frozen=True)
class GLMFlowConfig:
    input_size: int = 512
    output_size: int = 512
    heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    block_size: int = 10
    vocab_size: int = 16384
    spk_dim: int = 192
    mel_dim: int = 80
    input_frame_rate: float = 12.5
    mel_sample_rate: int = 22050
    mel_hop: int = 256
    regulator_layers: int = 4
    # estimator (ConditionalDecoder defaults)
    est_channels: tuple[int, ...] = (256, 256)
    est_head_dim: int = 64
    est_heads: int = 8
    est_n_blocks: int = 4
    est_mid_blocks: int = 12
    n_timesteps: int = 10
    cfg_rate: float = 0.7

    def feat_len(self, token_len: int) -> int:
        """Mel frames of ``token_len`` tokens (172 per 25)."""
        return int(token_len / self.input_frame_rate
                   * self.mel_sample_rate / self.mel_hop)

    @property
    def est_in(self) -> int:  # x + mu + spks + cond
        return self.mel_dim * 4

    @property
    def time_embed_dim(self) -> int:
        return self.est_channels[0] * 4


# ---------------------------------------------------------------------------
# init / load (the tree mirrors the torch module names)
# ---------------------------------------------------------------------------


def init_glm_flow(cfg: GLMFlowConfig, generator: torch.Generator,
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

    def gn_block(din, dout):
        return {"conv": conv(din, dout, 3),
                "gn_w": torch.ones((dout,), device=dev),
                "gn_b": torch.zeros((dout,), device=dev)}

    def resnet(din, dout):
        return {"mlp": lin(cfg.time_embed_dim, dout),
                "block1": gn_block(din, dout),
                "block2": gn_block(dout, dout),
                "res_conv": conv(din, dout, 1)}

    def tblock(dim):
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

    chs = cfg.est_channels
    down, inch = [], cfg.est_in
    for ch in chs:
        down.append({"resnet": resnet(inch, ch),
                     "blocks": [tblock(ch) for _ in range(cfg.est_n_blocks)],
                     "downsample": conv(ch, ch, 3)})
        inch = ch
    up_chs = tuple(reversed(chs)) + (chs[0],)
    up = []
    for i in range(len(up_chs) - 1):
        c = up_chs[i + 1]
        up.append({
            "resnet": resnet(up_chs[i] * 2, c),
            "blocks": [tblock(c) for _ in range(cfg.est_n_blocks)],
            "upsample": (conv(c, c, 3) if i == len(up_chs) - 2 else
                         init_conv_transpose1d(g, c, c, 4, dev)),
        })
    est = {
        "time_mlp": {"linear_1": lin(cfg.est_in, cfg.time_embed_dim),
                     "linear_2": lin(cfg.time_embed_dim,
                                     cfg.time_embed_dim)},
        "down": down,
        "mid": [{"resnet": resnet(chs[-1], chs[-1]),
                 "blocks": [tblock(chs[-1])
                            for _ in range(cfg.est_n_blocks)]}
                for _ in range(cfg.est_mid_blocks)],
        "up": up,
        "final_block": gn_block(chs[0], chs[0]),
        "final_proj": conv(chs[0], cfg.mel_dim, 1),
    }
    reg = {"convs": [gn_block(cfg.mel_dim, cfg.mel_dim)
                     for _ in range(cfg.regulator_layers)],
           "out": conv(cfg.mel_dim, cfg.mel_dim, 1)}
    return {
        "input_embedding": normal((cfg.vocab_size, cfg.input_size), 0.02),
        "spk_embed_affine_layer": lin(cfg.spk_dim, cfg.mel_dim),
        "encoder": {
            "embed_out": lin(cfg.input_size, d),
            "embed_norm": _ln(d, dev),
            "encoders": [conformer_layer() for _ in range(cfg.num_blocks)],
            "after_norm": _ln(d, dev),
        },
        "encoder_proj": lin(d, cfg.mel_dim),
        "length_regulator": reg,
        "estimator": est,
    }


def load_glm_flow_params(sd: dict, cfg: GLMFlowConfig, prefix: str = "", *,
                         device="cpu") -> dict:
    """Map the published ``flow.pt`` of zai-org/glm-4-voice-decoder
    (``GLMFlowModel.state_dict()``) onto ``init_glm_flow``'s tree."""
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

    def gn_block(pre):
        return {"conv": conv(f"{pre}.block.0"),
                "gn_w": arr(f"{pre}.block.1.weight"),
                "gn_b": arr(f"{pre}.block.1.bias")}

    def resnet(pre):
        return {"mlp": lin(f"{pre}.mlp.1"),
                "block1": gn_block(f"{pre}.block1"),
                "block2": gn_block(f"{pre}.block2"),
                "res_conv": conv(f"{pre}.res_conv")}

    def tblock(pre):
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

    def blocks(pre):
        return [tblock(f"{pre}.{j}") for j in range(cfg.est_n_blocks)]

    e = "decoder.estimator"
    n = len(cfg.est_channels)
    est = {
        "time_mlp": {"linear_1": lin(f"{e}.time_mlp.linear_1"),
                     "linear_2": lin(f"{e}.time_mlp.linear_2")},
        # Downsample1D / Upsample1D wrap their conv (".conv"); the last
        # level's plain conv does not
        "down": [{"resnet": resnet(f"{e}.down_blocks.{i}.0"),
                  "blocks": blocks(f"{e}.down_blocks.{i}.1"),
                  "downsample": conv(f"{e}.down_blocks.{i}.2"
                                     + (".conv" if i != n - 1 else ""))}
                 for i in range(n)],
        "mid": [{"resnet": resnet(f"{e}.mid_blocks.{i}.0"),
                 "blocks": blocks(f"{e}.mid_blocks.{i}.1")}
                for i in range(cfg.est_mid_blocks)],
        "up": [{"resnet": resnet(f"{e}.up_blocks.{i}.0"),
                "blocks": blocks(f"{e}.up_blocks.{i}.1"),
                "upsample": conv(f"{e}.up_blocks.{i}.2"
                                 + ("" if i == n - 1 else ".conv"))}
               for i in range(n)],
        "final_block": gn_block(f"{e}.final_block"),
        "final_proj": conv(f"{e}.final_proj"),
    }
    r = "length_regulator.model"
    reg = {"convs": [{"conv": conv(f"{r}.{3 * i}"),
                      "gn_w": arr(f"{r}.{3 * i + 1}.weight"),
                      "gn_b": arr(f"{r}.{3 * i + 1}.bias")}
                     for i in range(cfg.regulator_layers)],
           "out": conv(f"{r}.{3 * cfg.regulator_layers}")}
    return {
        "input_embedding": arr("input_embedding.weight"),
        "spk_embed_affine_layer": lin("spk_embed_affine_layer"),
        "encoder": {
            "embed_out": lin("encoder.embed.out.0"),
            "embed_norm": ln("encoder.embed.out.1"),
            "encoders": [conformer_layer(f"encoder.encoders.{i}")
                         for i in range(cfg.num_blocks)],
            "after_norm": ln("encoder.after_norm"),
        },
        "encoder_proj": lin("encoder_proj"),
        "length_regulator": reg,
        "estimator": est,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _group_norm8(x: torch.Tensor, w, b, groups: int = 8,
                 eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm over (B, C, T), statistics in the input's dtype as
    the JAX package takes them."""
    B, C, T = x.shape
    g = x.reshape(B, groups, C // groups, T)
    mean = torch.mean(g, dim=(2, 3), keepdim=True)
    var = torch.var(g, dim=(2, 3), keepdim=True, unbiased=False)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, C, T) * w[None, :, None] + b[None, :, None]


def _gn_block(p, x, groups: int = 8):
    y = conv1d(p["conv"], x, padding=1)
    return _mish(_group_norm8(y, p["gn_w"], p["gn_b"], groups))


def _gn_resnet(p, x, t_emb):
    """ResnetBlock1D (no mask: every frame of a window is real)."""
    h = _gn_block(p["block1"], x)
    h = h + linear(p["mlp"], _mish(t_emb))[:, :, None]
    h = _gn_block(p["block2"], h)
    return h + conv1d(p["res_conv"], x)


def _est_attention(p, cfg: GLMFlowConfig, x):
    """diffusers Attention without a mask. x (B, T, C)."""
    B, T, _ = x.shape
    H, hd = cfg.est_heads, cfg.est_head_dim
    q, k, v = (linear(p[n], x).reshape(B, T, H, hd).transpose(1, 2)
               for n in ("to_q", "to_k", "to_v"))
    attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B, T, H * hd)
    return linear(p["to_out"], out)


def _tblock(p, cfg: GLMFlowConfig, x):
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps=1e-5)
    x = x + _est_attention(p["attn1"], cfg, h)
    h = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=1e-5)
    return x + linear(p["ff"]["out"], F.gelu(linear(p["ff"]["proj"], h)))


def _blocks(blocks, cfg, h):
    ht = h.transpose(1, 2)
    for bp in blocks:
        ht = _tblock(bp, cfg, ht)
    return ht.transpose(1, 2)


def _estimator(est: dict, cfg: GLMFlowConfig, x, mu, t_scalar, spks, cond):
    """ConditionalDecoder.forward. x/mu/cond (B, mel, F); t_scalar (B,);
    spks (B, mel)."""
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
                   cond], dim=1)
    hiddens = []
    n_down = len(est["down"])
    for i, dp in enumerate(est["down"]):
        h = _gn_resnet(dp["resnet"], h, t_emb)
        h = _blocks(dp["blocks"], cfg, h)
        hiddens.append(h)
        # Downsample1D: stride 2 (the last level: a plain conv)
        h = conv1d(dp["downsample"], h, stride=2 if i != n_down - 1 else 1,
                   padding=1)
    for mp in est["mid"]:
        h = _gn_resnet(mp["resnet"], h, t_emb)
        h = _blocks(mp["blocks"], cfg, h)
    n_up = len(est["up"])
    for i, upb in enumerate(est["up"]):
        skip = hiddens.pop()
        h = torch.cat([h[:, :, :skip.shape[-1]], skip], dim=1)
        h = _gn_resnet(upb["resnet"], h, t_emb)
        h = _blocks(upb["blocks"], cfg, h)
        if i != n_up - 1:  # ConvTranspose1d(4, 2, padding=1)
            h = conv_transpose1d(upb["upsample"], h, stride=2, padding=1)
        else:
            h = conv1d(upb["upsample"], h, padding=1)
    h = _gn_block(est["final_block"], h)
    return conv1d(est["final_proj"], h)


def block_mask(T: int, block: int, device) -> torch.Tensor:
    """(T, T) bool: frame i attends j iff j <= i or both lie in the same
    ``block``-token block (the block conformer's grid mask)."""
    p = torch.arange(T, device=device)
    return ((p[None, :] <= p[:, None])
            | (p[None, :] // block == p[:, None] // block))


def glm_flow_forward(params: dict, cfg: GLMFlowConfig, tokens: torch.Tensor,
                     spk: torch.Tensor, *,
                     noise: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) int, spk (B, spk_dim), noise (1 or B, mel,
    feat_len(T)) the solver's start -> mel (B, mel, feat_len(T)).

    GLMFlowModel.inference: the encoder, the regulator, then the 10-step
    cosine Euler solver with classifier-free guidance."""
    B, T = tokens.shape
    d = cfg.output_size
    spk_n = spk / torch.clamp(torch.linalg.vector_norm(spk, dim=1,
                                                       keepdim=True),
                              min=1e-12)
    spk_e = linear(params["spk_embed_affine_layer"], spk_n)    # (B, mel)

    emb = params["input_embedding"][
        torch.clamp(tokens.long(), 0, cfg.vocab_size - 1)]
    enc = params["encoder"]
    x = linear(enc["embed_out"], emb)
    x = layer_norm(x, enc["embed_norm"]["w"], enc["embed_norm"]["b"],
                   eps=1e-5)
    x = x * math.sqrt(d)
    pos_emb = _rel_pos_emb(d, T, x.device)
    mask = block_mask(T, cfg.block_size, x.device)[None].expand(B, T, T)
    for lp in enc["encoders"]:
        x = _conformer_layer(lp, cfg, x, pos_emb, mask)
    x = layer_norm(x, enc["after_norm"]["w"], enc["after_norm"]["b"],
                   eps=1e-5)
    h = linear(params["encoder_proj"], x)                      # (B, T, mel)

    # InterpolateRegulator: nearest resize to feat_len, conv/GN/Mish stack
    Fn = cfg.feat_len(T)
    idx = torch.arange(Fn, device=h.device) * T // Fn
    hm = h.transpose(1, 2)[:, :, idx]                          # (B, mel, F)
    reg = params["length_regulator"]
    for cp in reg["convs"]:
        hm = conv1d(cp["conv"], hm, padding=1)
        hm = _mish(_group_norm8(hm, cp["gn_w"], cp["gn_b"], groups=1))
    mu = conv1d(reg["out"], hm)                                # (B, mel, F)

    x = noise.to(mu.dtype).expand(B, cfg.mel_dim, Fn)
    ts = cfm_timesteps(cfg.n_timesteps)
    # the unconditional half of the doubled batch: no mu, speaker or cond
    # (the cond is zeros in both halves)
    mu_in = torch.cat([mu, torch.zeros_like(mu)])
    spk_in = torch.cat([spk_e, torch.zeros_like(spk_e)])
    cond_in = torch.zeros_like(mu_in)
    for step in range(1, cfg.n_timesteps + 1):
        t, dt = ts[step - 1], ts[step] - ts[step - 1]
        t_in = torch.full((2 * B,), t, dtype=mu.dtype, device=mu.device)
        dphi = _estimator(params["estimator"], cfg, torch.cat([x, x]),
                          mu_in, t_in, spk_in, cond_in)
        dphi = (1.0 + cfg.cfg_rate) * dphi[:B] - cfg.cfg_rate * dphi[B:]
        x = x + dt * dphi
    return x
