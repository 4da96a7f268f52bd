"""Plain reference of CosyVoice2-0.5B as the port serves it with random
weights: the Qwen2-0.5B LM over the prompt's feature rows and the served
speech tokens, and the detokenizer (the flow's conformer encoder and its
10-step classifier-free-guided Euler solver over the causal U-Net
estimator, then streaming HiFT), in float32 (or the control's fp8,
``common.Precision``).

Sizes come from the configuration file's ``model`` section. The weights
and the flow's start noise are the port's random init for ``--seed``
(``common.Recipe``, the draw order of the port's
``CosyVoice2LM._init_params``: the LM, the flow (its estimator first),
HiFT, the dev speech tokenizer and speaker encoder (drawn and dropped
here: a plain request uses neither), then the noise of the 28-, 53- and
103-token windows). The prompt is [sos] + the text (the char-level
tokenizer the port falls back to) + [task_id], every row its table's
embedding.

Served greedy tokens are judged by teacher forcing (one causal pass over
the prompt and the served tokens). The detokenizer follows the port's
windows: each re-decodes 25 tokens of left context and the window under
the streaming masks, emits the mel of its first (length - 3) tokens, and
HiFT decodes that mel with 6 frames of carried context and a Hamming
crossfade; a short last window repeats its last token and is trimmed to
int(samples * (valid - 0.5) / (length - 3)) samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import (Precision, Recipe, decoder_forward, layer_norm,
                     no_tf32, pcm_sums, widest_gap)

SOS, TASK_ID = 0, 1
FLOW_CTX = 25
OVERLAP = 3
NOISE_WINDOWS = (28, 53, 103)


def dev_tokenize(text: str, vocab: int, offset: int = 64) -> list[int]:
    """The char-level tokenizer the port serves without a checkpoint."""
    return [offset + (ord(c) * 2654435761) % (vocab - offset - 1)
            for c in text]


# ---------------------------------------------------------------------------
# the port's random init, in its draw order
# ---------------------------------------------------------------------------


def make_weights(m: dict, seed: int, device) -> dict:
    r = Recipe(seed, device)
    bf = torch.bfloat16
    lm = m["lm"]
    H = lm["hidden"]
    w = {"lm": r.decoder_stack(lm["layers"], H, lm["heads"],
                               lm["kv_heads"], lm["head_dim"],
                               lm["intermediate"], bf, qkv_bias=True)}
    w["text_embed"] = r.normal((lm["text_vocab"], H), 0.02, bf)
    w["speech_embed"] = r.normal((lm["speech_vocab"], H), 0.02, bf)
    w["llm_embed"] = r.normal((2, H), 0.02, bf)
    w["head"] = r.normal((H, lm["speech_vocab"]), 0.02, bf)
    w["flow"] = _flow(m["flow"], r)
    w["hift"] = _hift(m["hift"], r)
    _drop_clone_encoders(m, r)
    fl = m["flow"]
    w["noise"] = {}
    for n in NOISE_WINDOWS:
        frames = fl["token_mel_ratio"] * (FLOW_CTX + n)
        w["noise"][n] = r.randn((1, fl["mel_dim"], frames))
    return w


def _flow(f: dict, r: Recipe) -> dict:
    d = f["output_size"]
    F32 = torch.float32

    def lin(din, dout, bias=True):
        return r.linear(din, dout, F32, bias)

    def ln(dim):
        return {"w": r.ones(dim), "b": r.zeros(dim)}

    def conformer():
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                "out": lin(d, d), "pos": lin(d, d, bias=False),
                "bias_u": r.randn((f["heads"], d // f["heads"])) * 0.02,
                "bias_v": r.randn((f["heads"], d // f["heads"])) * 0.02,
                "w_1": lin(d, f["linear_units"]),
                "w_2": lin(f["linear_units"], d),
                "norm_mha": ln(d), "norm_ff": ln(d)}

    def causal_block(din, dout):
        return {"conv": r.conv(din, dout, 3), "norm": ln(dout)}

    ted = 4 * f["est_channels"]

    def resnet(din, dout):
        return {"mlp": lin(ted, dout), "block1": causal_block(din, dout),
                "block2": causal_block(dout, dout),
                "res_conv": r.conv(din, dout, 1)}

    def block(dim):
        inner = f["est_heads"] * f["est_head_dim"]
        return {"norm1": ln(dim), "to_q": lin(dim, inner, bias=False),
                "to_k": lin(dim, inner, bias=False),
                "to_v": lin(dim, inner, bias=False),
                "to_out": lin(inner, dim), "norm3": ln(dim),
                "proj": lin(dim, 4 * dim), "out": lin(4 * dim, dim)}

    ch, est_in, nb = f["est_channels"], 4 * f["mel_dim"], f["est_n_blocks"]
    est = {"time_1": lin(est_in, ted), "time_2": lin(ted, ted)}
    est["down"] = {"resnet": resnet(est_in, ch),
                   "blocks": [block(ch) for _ in range(nb)],
                   "sample": r.conv(ch, ch, 3)}
    est["mid"] = [{"resnet": resnet(ch, ch),
                   "blocks": [block(ch) for _ in range(nb)]}
                  for _ in range(f["est_mid_blocks"])]
    est["up"] = {"resnet": resnet(2 * ch, ch),
                 "blocks": [block(ch) for _ in range(nb)],
                 "sample": r.conv(ch, ch, 3)}
    est["final_block"] = causal_block(ch, ch)
    est["final_proj"] = r.conv(ch, f["mel_dim"], 1)
    p = {"input_embedding": r.randn((f["vocab_size"], f["input_size"]))
         * 0.02,
         "spk_affine": lin(f["spk_dim"], f["mel_dim"])}
    p["embed_out"] = lin(f["input_size"], d)
    p["embed_norm"] = ln(d)
    p["up_embed_out"] = lin(f["input_size"], d)
    p["up_embed_norm"] = ln(d)
    p["pre1"] = r.conv(d, d, f["pre_lookahead"] + 1)
    p["pre2"] = r.conv(d, d, 3)
    p["encoders"] = [conformer() for _ in range(f["num_blocks"])]
    p["up_conv"] = r.conv(d, d, 5)
    p["up_encoders"] = [conformer() for _ in range(f["up_blocks"])]
    p["after_norm"] = ln(d)
    p["encoder_proj"] = lin(d, f["mel_dim"])
    p["est"] = est
    return p


def _hift(h: dict, r: Recipe) -> dict:
    def resblock(ch, k, dils):
        return {"convs1": [r.conv(ch, ch, k) for _ in dils],
                "convs2": [r.conv(ch, ch, k) for _ in dils],
                "alpha1": [r.ones(ch) for _ in dils],
                "alpha2": [r.ones(ch) for _ in dils]}

    fc = h["f0_cond_channels"]
    p = {"f0_convs": [r.conv(h["in_channels"] if i == 0 else fc, fc, 3)
                      for i in range(5)]}
    p["f0_out_w"] = r.randn((fc, 1)) * 0.02
    p["f0_out_b"] = r.zeros(1)
    p["source_w"] = r.randn((h["nb_harmonics"] + 1, 1)) * 0.3
    p["source_b"] = r.zeros(1)
    p["conv_pre"] = r.conv(h["in_channels"], h["base_channels"], 7)
    p["ups"], p["source_downs"], p["source_res"], p["res"] = [], [], [], []
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        cin = h["base_channels"] // 2 ** i
        cout = cin // 2
        p["ups"].append(r.tconv(cin, cout, k))
        d = source_down(h)[i]
        p["source_downs"].append(r.conv(h["n_fft"] + 2, cout,
                                        1 if d == 1 else 2 * d))
        p["source_res"].append(resblock(
            cout, h["source_resblock_kernel_sizes"][i],
            h["resblock_dilations"][i]))
        for k2, dil in zip(h["resblock_kernel_sizes"],
                           h["resblock_dilations"]):
            p["res"].append(resblock(cout, k2, dil))
    final = h["base_channels"] // 2 ** len(h["upsample_rates"])
    p["conv_post"] = r.conv(final, h["n_fft"] + 2, 7)
    return p


def _drop_clone_encoders(m: dict, r: Recipe) -> None:
    """The draws of the dev speech tokenizer and the dev speaker encoder,
    which the port makes after HiFT and a plain request never uses."""
    s = m["dev_s3v2"]
    C = s["n_state"]

    def lin(cin, cout):
        r.randn((cout, cin))

    r.randn((C, s["n_mels"], 3))
    r.randn((C, C, 3))
    for _ in range(s["layers"]):
        lin(C, C), lin(C, C), lin(C, C), lin(C, C)
        r.randn((C, 1, s["fsmn_kernel"]))
        lin(C, 4 * C), lin(4 * C, C)
    lin(C, s["fsq_dim"])
    e = m["dev_speaker"]
    cin = e["n_mels"]
    for _ in range(e["layers"]):
        r.conv(cin, e["channels"], 3)
        cin = e["channels"]
    r.conv(e["channels"], 128, 1)
    r.conv(128, e["channels"], 1)
    r.linear(2 * e["channels"], e["out_dim"], torch.float32, bias=True)


def source_down(h: dict) -> list[int]:
    rates = list(h["upsample_rates"])
    return [int(d) for d in np.cumprod([1] + rates[::-1][:-1])[::-1]]


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------


def _rel_pos_emb(d: int, T: int, device) -> torch.Tensor:
    f64 = torch.float64
    rel = torch.arange(T - 1, -T, -1, dtype=f64, device=device)
    div = torch.exp(torch.arange(0, d, 2, dtype=f64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.stack([torch.sin(rel[:, None] * div[None, :]),
                      torch.cos(rel.abs()[:, None] * div[None, :])], dim=-1)
    return pe.reshape(2 * T - 1, d).float()[None]


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    B, H, T, _ = x.shape
    xp = F.pad(x, (1, 0)).reshape(B, H, 2 * T, T)
    return xp[:, :, 1:].reshape(B, H, T, 2 * T - 1)[:, :, :, :T]


def _softmax(scores, mask):
    return torch.softmax(scores.masked_fill(~mask, torch.finfo(
        torch.float32).min), dim=-1)


def _mask(valid: torch.Tensor, chunk: int) -> torch.Tensor:
    """Key mask and the block-causal streaming chunk mask: (B, T, T)."""
    T = valid.shape[1]
    pos = torch.arange(T, device=valid.device)
    chunk_m = pos[None, :] < ((pos // chunk + 1) * chunk)[:, None]
    return valid[:, None, :] & chunk_m[None]


def _conformer(p, f, x, pos_emb, mask, prec: Precision):
    B, T, d = x.shape
    H = f["heads"]
    dk = d // H
    h = layer_norm(x, p["norm_mha"]["w"], p["norm_mha"]["b"], 1e-12)
    q = prec.linear(p["q"], h).reshape(B, T, H, dk)
    k = prec.linear(p["k"], h).reshape(B, T, H, dk).transpose(1, 2)
    v = prec.linear(p["v"], h).reshape(B, T, H, dk).transpose(1, 2)
    pe = prec.linear(p["pos"], pos_emb).reshape(1, -1, H, dk).transpose(1, 2)
    q_u = (q + p["bias_u"][None, None]).transpose(1, 2)
    q_v = (q + p["bias_v"][None, None]).transpose(1, 2)
    scores = (prec.mm(q_u, k.transpose(-1, -2))
              + _rel_shift(prec.mm(q_v, pe.transpose(-1, -2)))) / math.sqrt(
                  dk)
    m = mask[:, None]
    attn = _softmax(scores, m).masked_fill(~m, 0.0)
    x = x + prec.linear(p["out"], prec.mm(attn, v).transpose(1, 2)
                        .reshape(B, T, d))
    h = layer_norm(x, p["norm_ff"]["w"], p["norm_ff"]["b"], 1e-12)
    return x + prec.linear(p["w_2"], F.silu(prec.linear(p["w_1"], h)))


def _encoder(p, f, emb, valid, prec: Precision):
    d = f["output_size"]
    x = prec.linear(p["embed_out"], emb)
    x = layer_norm(x, p["embed_norm"]["w"], p["embed_norm"]["b"], 1e-5)
    x = x * math.sqrt(d)
    y = F.pad(x.transpose(1, 2), (0, f["pre_lookahead"]))
    y = F.leaky_relu(prec.conv1d(p["pre1"], y), 0.01)
    y = prec.conv1d(p["pre2"], F.pad(y, (2, 0)))
    x = x + y.transpose(1, 2)
    T = x.shape[1]
    pos = _rel_pos_emb(d, T, x.device)
    mask = _mask(valid, f["static_chunk_size"])
    for lp in p["encoders"]:
        x = _conformer(lp, f, x, pos, mask, prec)
    xt = torch.repeat_interleave(x.transpose(1, 2), 2, dim=-1)
    x = prec.conv1d(p["up_conv"], F.pad(xt, (4, 0))).transpose(1, 2)
    x = prec.linear(p["up_embed_out"], x)
    x = layer_norm(x, p["up_embed_norm"]["w"], p["up_embed_norm"]["b"],
                   1e-5) * math.sqrt(d)
    pos2 = _rel_pos_emb(d, 2 * T, x.device)
    mask2 = _mask(torch.repeat_interleave(valid, 2, dim=-1),
                  2 * f["static_chunk_size"])
    for lp in p["up_encoders"]:
        x = _conformer(lp, f, x, pos2, mask2, prec)
    return layer_norm(x, p["after_norm"]["w"], p["after_norm"]["b"], 1e-5)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _causal_block(p, x, mask, prec):
    y = prec.conv1d(p["conv"], F.pad(x * mask, (2, 0)))
    y = layer_norm(y.transpose(1, 2), p["norm"]["w"], p["norm"]["b"],
                   1e-5).transpose(1, 2)
    return _mish(y) * mask


def _resnet(p, x, mask, t_emb, prec):
    h = _causal_block(p["block1"], x, mask, prec)
    h = h + prec.linear(p["mlp"], _mish(t_emb))[:, :, None]
    h = _causal_block(p["block2"], h, mask, prec)
    return h + prec.conv1d(p["res_conv"], x * mask)


def _blocks(blocks, f, h, am, prec):
    x = h.transpose(1, 2)
    B, T, _ = x.shape
    H = f["est_heads"]
    for p in blocks:
        y = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], 1e-5)
        q, k, v = (prec.linear(p[n], y) for n in ("to_q", "to_k", "to_v"))
        hd = q.shape[-1] // H
        q, k, v = (a.reshape(B, T, H, hd).transpose(1, 2) for a in (q, k, v))
        a = _softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd),
                     am[:, None])
        x = x + prec.linear(p["to_out"], prec.mm(a, v).transpose(1, 2)
                            .reshape(B, T, H * hd))
        y = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], 1e-5)
        x = x + prec.linear(p["out"], F.gelu(prec.linear(p["proj"], y)))
    return x.transpose(1, 2)


def _estimator(e, f, x, mask, mu, t, spks, cond, prec):
    B, _, T = x.shape
    half = 2 * f["mel_dim"]
    freqs = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32)
                      * -(math.log(10000) / (half - 1)))
    te = 1000.0 * t[:, None] * freqs[None]
    te = torch.cat([torch.sin(te), torch.cos(te)], dim=-1)
    t_emb = prec.linear(e["time_2"], F.silu(prec.linear(e["time_1"], te)))
    h = torch.cat([x, mu, spks[:, :, None].expand(B, spks.shape[1], T),
                   cond], dim=1)
    am = _mask(mask[:, 0] > 0, f["est_static_chunk"])
    h = _resnet(e["down"]["resnet"], h, mask, t_emb, prec)
    skip = h = _blocks(e["down"]["blocks"], f, h, am, prec)
    h = prec.conv1d(e["down"]["sample"], F.pad(h * mask, (2, 0)))
    for mp in e["mid"]:
        h = _resnet(mp["resnet"], h, mask, t_emb, prec)
        h = _blocks(mp["blocks"], f, h, am, prec)
    h = _resnet(e["up"]["resnet"], torch.cat([h, skip], 1), mask, t_emb,
                prec)
    h = _blocks(e["up"]["blocks"], f, h, am, prec)
    h = prec.conv1d(e["up"]["sample"], F.pad(h * mask, (2, 0)))
    h = _causal_block(e["final_block"], h, mask, prec)
    return prec.conv1d(e["final_proj"], h * mask) * mask


def flow_forward(p, f, tokens, valid, noise, prec: Precision
                 ) -> torch.Tensor:
    """tokens (1, T), valid (1, T) -> mel (1, mel, 2T); no voice clone:
    zero x-vector and no prompt-mel anchor."""
    B, T = tokens.shape
    spk_e = prec.linear(p["spk_affine"], torch.zeros(
        (B, f["spk_dim"]), device=tokens.device))
    emb = p["input_embedding"][tokens.long().clamp(0, f["vocab_size"] - 1)]
    emb = emb * valid[:, :, None].float()
    mu = prec.linear(p["encoder_proj"], _encoder(p, f, emb, valid, prec)
                     ).transpose(1, 2)
    mask = torch.repeat_interleave(valid, 2, dim=-1)[:, None, :].float()
    x = noise.expand(B, f["mel_dim"], 2 * T)
    n = f["n_timesteps"]
    ts = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    ts = [float(v) for v in np.float32(1.0) - np.cos(
        ts * np.float32(0.5 * np.pi), dtype=np.float32)]
    zeros = torch.zeros_like(mu)
    mu_in = torch.cat([mu, zeros])
    spk_in = torch.cat([spk_e, torch.zeros_like(spk_e)])
    cond_in = torch.cat([zeros, zeros])
    mask_in = torch.cat([mask, mask])
    rate = f["cfg_rate"]
    for s in range(1, n + 1):
        t_in = torch.full((2 * B,), ts[s - 1], device=mu.device)
        d = _estimator(p["est"], f, torch.cat([x, x]), mask_in, mu_in, t_in,
                       spk_in, cond_in, prec)
        x = x + (ts[s] - ts[s - 1]) * ((1.0 + rate) * d[:B] - rate * d[B:])
    return x


# ---------------------------------------------------------------------------
# HiFT
# ---------------------------------------------------------------------------


def _snake(x, alpha):
    a = alpha[None, :, None]
    return x + (1.0 / (a + 1e-9)) * torch.sin(a * x).square()


def _conv(prec, p, x, padding=0, stride=1, dilation=1):
    return F.conv1d(prec.q(x), prec.q(p["w"]), p["b"], stride=stride,
                    padding=padding, dilation=dilation)


def _resblock(prec, p, x, k, dils):
    for i, d in enumerate(dils):
        xt = _snake(x, p["alpha1"][i])
        xt = _conv(prec, p["convs1"][i], xt, padding=(k * d - d) // 2,
                   dilation=d)
        xt = _snake(xt, p["alpha2"][i])
        x = x + _conv(prec, p["convs2"][i], xt, padding=(k - 1) // 2)
    return x


def _hann(n, device):
    return torch.hann_window(n, periodic=True, dtype=torch.float64,
                             device=device).float()


def _reflect_pad(x, pad):
    n = x.shape[-1]
    period = max(2 * (n - 1), 1)
    i = torch.remainder(torch.arange(-pad, n + pad, device=x.device), period)
    return x[..., torch.where(i >= n, period - i, i)]


def _overlap_add(frames, window, hop, floor):
    B, Fr, n = frames.shape
    total = n + hop * (Fr - 1)

    def fold(x):
        return F.fold(x.transpose(1, 2), (1, total), (1, n),
                      stride=(1, hop))[:, 0, 0]

    den = fold(torch.square(window).expand(1, Fr, n))
    return fold(frames * window) / torch.where(den > floor, den,
                                               torch.ones_like(den))


def hift_decode(p, h, mel, source_cache, prec: Precision):
    """mel (1, 80, T) -> (wav (1, T * 480), source (1, 1, T * 480))."""
    up = int(np.prod(h["upsample_rates"])) * h["hop_len"]
    x = mel
    for c in p["f0_convs"]:
        x = F.elu(_conv(prec, c, x, padding=1))
    f0 = torch.abs(prec.mm(x.transpose(1, 2), p["f0_out_w"])
                   + p["f0_out_b"])[:, :, 0]
    f0s = torch.repeat_interleave(f0, up, dim=1)
    harm = torch.arange(1, h["nb_harmonics"] + 2, device=mel.device,
                        dtype=torch.float32)
    rad = (f0s[:, :, None] * harm[None, None, :]) / h["sampling_rate"]
    phase = 2.0 * math.pi * torch.cumsum(torch.remainder(rad, 1.0), dim=1)
    uv = (f0s > h["nsf_voiced_threshold"]).float()[:, :, None]
    sines = h["nsf_alpha"] * torch.sin(phase) * uv
    s = torch.tanh(sines @ p["source_w"] + p["source_b"]).transpose(1, 2)
    keep = source_cache.shape[2]
    s = torch.cat([source_cache, s[:, :, keep:]], dim=2)
    n, hop = h["n_fft"], h["hop_len"]
    fr = _reflect_pad(s[:, 0], n // 2).unfold(-1, n, hop) * _hann(
        n, mel.device)
    spec = torch.fft.rfft(fr, dim=-1)
    s_stft = torch.cat([spec.real, spec.imag], dim=-1).transpose(1, 2)
    x = _conv(prec, p["conv_pre"], mel, padding=3)
    nk = len(h["resblock_kernel_sizes"])
    rates = h["upsample_rates"]
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, h["lrelu_slope"])
        x = F.conv_transpose1d(prec.q(x), prec.q(p["ups"][i]["w"]),
                               p["ups"][i]["b"], stride=u,
                               padding=(k - u) // 2)
        if i == len(rates) - 1:
            x = F.pad(x, (1, 0), mode="reflect")
        d = source_down(h)[i]
        si = (_conv(prec, p["source_downs"][i], s_stft) if d == 1 else
              _conv(prec, p["source_downs"][i], s_stft, padding=d // 2,
                    stride=d))
        x = x + _resblock(prec, p["source_res"][i], si,
                          h["source_resblock_kernel_sizes"][i],
                          h["resblock_dilations"][i])
        xs = None
        for j in range(nk):
            r_ = _resblock(prec, p["res"][i * nk + j], x,
                           h["resblock_kernel_sizes"][j],
                           h["resblock_dilations"][j])
            xs = r_ if xs is None else xs + r_
        x = xs / nk
    x = _conv(prec, p["conv_post"], F.leaky_relu(x, 0.01), padding=3)
    half = n // 2 + 1
    mag = torch.clamp(torch.exp(x[:, :half]), max=1e2)
    ph = torch.sin(x[:, half:])
    comp = torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    frames = torch.fft.irfft(comp.transpose(1, 2), n=n, dim=-1)
    sig = _overlap_add(frames, _hann(n, mel.device), hop, 1e-8)
    wav = sig[:, n // 2:-(n // 2)]
    return torch.clamp(wav, -h["audio_limit"], h["audio_limit"]), s


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


class CosyReference:
    def __init__(self, model: dict, seed: int, device,
                 precision: str = "float32"):
        self.m = model
        self.device = torch.device(device)
        self.prec = Precision(precision)
        self.w = make_weights(model, seed, self.device)

    def logits(self, text: str, tokens: torch.Tensor) -> torch.Tensor:
        """(n, vocab): the LM's logits at each served token."""
        w, lm = self.w, self.m["lm"]
        ids = torch.tensor(dev_tokenize(text, lm["text_vocab"]),
                           device=self.device) % lm["text_vocab"]
        rows = [w["llm_embed"][SOS][None].float(),
                w["text_embed"][ids].float(),
                w["llm_embed"][TASK_ID][None].float()]
        T = sum(r.shape[0] for r in rows)
        fed = tokens[:-1].long().clamp(0, lm["speech_vocab"] - 1)
        rows.append(w["speech_embed"][fed].float())
        x = torch.cat(rows)[None]
        pos = torch.arange(x.shape[1], device=self.device)
        cfg = {"layers": lm["layers"], "heads": lm["heads"],
               "kv_heads": lm["kv_heads"], "head_dim": lm["head_dim"],
               "rope_theta": lm["rope_theta"], "eps": lm["eps"]}
        h = decoder_forward(w["lm"], x, pos, cfg, self.prec)[0, T - 1:]
        return self.prec.mm(h, w["head"])

    def decode_stream(self, tokens: torch.Tensor, windows: list
                      ) -> torch.Tensor:
        """The PCM the port emits for the audio tokens (n,) over its
        planned windows [(start, length), ...]."""
        f, h = self.m["flow"], self.m["hift"]
        r = f["token_mel_ratio"]
        up = int(np.prod(h["upsample_rates"])) * h["hop_len"]
        ctx = torch.zeros(FLOW_CTX, dtype=torch.long, device=self.device)
        pos0 = 0
        hc = 6  # HiFT's mel context frames
        cache = {"mel": torch.zeros(1, h["in_channels"], hc,
                                    device=self.device),
                 "source": torch.zeros(1, 1, hc * up, device=self.device),
                 "speech": torch.zeros(1, hc * up, device=self.device),
                 "primed": False}
        out = []
        for start, L in windows:
            win = tokens[start:start + L].long()
            valid_n = win.shape[0]
            if valid_n == 0:
                continue
            if valid_n < L:
                win = torch.cat([win, win[-1:].expand(L - valid_n)])
            win = win.clamp(0, f["vocab_size"] - 1)
            step = L - OVERLAP
            toks = torch.cat([ctx, win])[None]
            valid = (pos0 + torch.arange(FLOW_CTX + L, device=self.device)
                     - FLOW_CTX >= 0)[None]
            mel = flow_forward(self.w["flow"], f, toks, valid,
                               self.w["noise"][L], self.prec)
            mel = mel[:, :, FLOW_CTX * r: FLOW_CTX * r + step * r]
            wav, cache = self._hift_chunk(mel, cache, hc * up)
            if valid_n < step:
                wav = wav[:, :max(int(wav.shape[1] * (valid_n - 0.5)
                                      / step), 0)]
            out.append(wav[0])
            ctx = torch.cat([ctx, win[:step]])[-FLOW_CTX:]
            pos0 += step
        return torch.cat(out) if out else torch.zeros(0, device=self.device)

    def _hift_chunk(self, mel, cache, n):
        h = self.m["hift"]
        mel_in = torch.cat([cache["mel"], mel], dim=2)
        wav, source = hift_decode(self.w["hift"], h, mel_in, cache["source"],
                                  self.prec)
        window = torch.hamming_window(2 * n, periodic=False,
                                      dtype=torch.float64,
                                      device=mel.device).float()
        head = wav[:, :n] * window[None, :n] + cache["speech"] * window[
            None, n:]
        if not cache["primed"]:
            head = torch.zeros_like(head)
        wav = torch.cat([head, wav[:, n:]], dim=1)
        new = {"mel": mel_in[:, :, -cache["mel"].shape[2]:],
               "source": source[:, :, -n:], "speech": wav[:, -n:],
               "primed": True}
        return wav[:, :-n], new

    @torch.no_grad()
    def judge(self, item: dict, control: "CosyReference | None" = None
              ) -> dict:
        with no_tf32():
            return self._judge(item, control)

    def _judge(self, item: dict, control) -> dict:
        dev = self.device
        toks = torch.tensor([row[0] for row in item["tokens"]], device=dev)
        lg = self.logits(item["prompt"], toks)
        out = {"lm_gap": float(widest_gap(lg, toks).max())}
        n_audio = item["audio_tokens"]
        ref = self.decode_stream(toks[:n_audio], item["windows"])
        ref16 = (ref.clamp(-1, 1) * 32767.0).trunc() / 32767.0
        served = torch.tensor(item["pcm"], device=dev).float() / 32767.0
        out["pcm_len_diff"] = abs(int(served.numel()) - int(ref16.numel()))
        k = min(served.numel(), ref16.numel())
        out["pcm_sq_err"], out["pcm_samples"] = pcm_sums(served[:k],
                                                         ref16[:k])
        if control is not None:
            clg = control.logits(item["prompt"], toks)
            out["ctl_lm_gap"] = float(widest_gap(lg, clg.argmax(-1)).max())
            c = control.decode_stream(toks[:n_audio], item["windows"])
            c16 = (c.clamp(-1, 1) * 32767.0).trunc() / 32767.0
            out["ctl_pcm_sq_err"], _ = pcm_sums(c16[:k], ref16[:k])
        return out


def make_reference(model: dict, seed: int, device,
                   precision: str = "float32") -> CosyReference:
    return CosyReference(model, seed, device, precision)


def attention_dims(m: dict) -> dict:
    lm = m["lm"]
    return {"heads": lm["heads"], "kv_heads": lm["kv_heads"],
            "head_dim": lm["head_dim"], "layers": lm["layers"]}


def _layer_params(lm: dict) -> int:
    H, D = lm["hidden"], lm["head_dim"]
    return (H * lm["heads"] * D * 2 + H * lm["kv_heads"] * D * 2
            + 3 * H * lm["intermediate"])


def decode_flops(m: dict, rows: int, keys: int) -> float:
    lm = m["lm"]
    per_row = (2 * lm["layers"] * _layer_params(lm)
               + 2 * lm["hidden"] * lm["speech_vocab"])
    return rows * per_row + 4.0 * lm["layers"] * lm["heads"] * \
        lm["head_dim"] * keys


def prefill_flops(m: dict, tokens: int, pairs: int, rows: int) -> float:
    lm = m["lm"]
    return (tokens * 2 * lm["layers"] * _layer_params(lm)
            + 4.0 * lm["layers"] * lm["heads"] * lm["head_dim"] * pairs
            + rows * 2 * lm["hidden"] * lm["speech_vocab"])
