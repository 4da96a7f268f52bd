"""Plain reference of Qwen3-TTS-12Hz-1.7B-CustomVoice as the port serves it
with random weights: the talker over the dual-channel prompt, the 5-layer
code predictor over the 15 acoustic codebooks, and the 12 Hz codec
decoder, in float32 (or the control's fp8, ``common.Precision``).

Sizes come from the configuration file's ``model`` section. The weights
are the port's random init for ``--seed`` (``common.Recipe``, the draw
order of the port's ``Qwen3TTSLM._init_params``). The prompt is built
from the request's text as the port's ``preprocess`` builds a
CustomVoice prompt (role, codec think prefix with the language id, the
preset speaker, tts_bos, the text over codec_pad, tts_eos, codec_bos), with
the char-level tokenizer the port falls back to without a checkpoint.

Served greedy tokens are judged by teacher forcing: one causal pass of the
talker over the prompt and the served frames gives, at each frame, the
logits of codebook 0 (the static suppression of [vocab - 1024, vocab)
except codec EOS, then the repetition penalty over the codebook-0 tokens
served before it); one causal pass of the code predictor over [hidden,
codebook 0, codebooks 1..14] gives those of codebooks 1..15. The codec
decodes the served frames window by window as the port's streaming codec
does: the windows the daemon planned, a 72-slot attention ring updated
before it is read (its zero slots included), causal convolutions with
their left context, a short last window padded with its last frame and
trimmed to int(samples * (valid - 0.5) / length) samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (F32, Precision, Recipe, attention, decoder_forward,
                     layer_norm, no_tf32, pcm_sums, rms_norm, widest_gap)

TTS_BOS, TTS_EOS, TTS_PAD = 151672, 151673, 151671
CODEC_BOS, CODEC_EOS, CODEC_PAD = 2149, 2150, 2148
CODEC_THINK, CODEC_THINK_BOS, CODEC_THINK_EOS = 2154, 2156, 2157
LANGUAGE_IDS = {"english": 2050, "chinese": 2055, "german": 2053,
                "spanish": 2054, "french": 2061}
SPEAKER_IDS = {"ryan": 2090, "vivian": 2091, "serena": 2092}


def dev_tokenize(text: str, vocab: int, offset: int = 64) -> list[int]:
    """The char-level tokenizer the port serves without a checkpoint."""
    return [offset + (ord(c) * 2654435761) % (vocab - offset - 1)
            for c in text]


def make_weights(m: dict, seed: int, device) -> dict:
    """The port's random Qwen3-TTS weights for ``seed``, in its draw
    order: talker stack, codec embedding, text embedding, text projection,
    codec head, code predictor stack, its input projection, its codebook
    embeddings and heads, then the codec decoder (float32)."""
    r = Recipe(seed, device)
    bf = torch.bfloat16
    t, d, c = m["talker"], m["depth"], m["codec"]
    H = t["hidden"]
    w = {"talker": r.decoder_stack(t["layers"], H, t["heads"],
                                   t["kv_heads"], t["head_dim"],
                                   t["intermediate"], bf, qk_norm=True)}
    w["codec_embedding"] = r.normal((t["vocab"], H), 0.02, bf)
    w["text_embedding"] = r.normal((t["text_vocab"], H), 0.02, bf)
    w["fc1"] = r.linear(H, H, bf, bias=True)
    w["fc2"] = r.linear(H, H, bf, bias=True)
    w["codec_head"] = r.normal((H, t["vocab"]), 0.02, bf)
    Dh = d["hidden"]
    w["depth"] = r.decoder_stack(d["layers"], Dh, d["heads"], d["kv_heads"],
                                 d["head_dim"], d["intermediate"], bf,
                                 qk_norm=True)
    w["depth_proj"] = r.linear(H, Dh, bf, bias=True)
    G = d["codebooks"]
    w["depth_embeds"] = r.normal((G - 1, d["vocab"], H), 0.02, bf)
    w["depth_heads"] = r.normal((G - 1, Dh, d["vocab"]), 0.02, bf)
    w["codec"] = make_codec(c, r)
    return w


def make_codec(c: dict, r: Recipe) -> dict:
    """The port's ``init_qwen3_codec`` draw order (float32)."""
    def vq_group(n_q):
        return {"embed_sum": r.randn((n_q, c["codebook_size"], c["vq_dim"]))
                * 0.02,
                "usage": r.ones(n_q, c["codebook_size"]),
                "out_proj": r.conv(c["vq_dim"], c["codebook_dim"], 1,
                                   bias=False)}

    p = {"rvq_first": vq_group(1),
         "rvq_rest": vq_group(c["quantizers"] - 1),
         "pre_conv": r.conv(c["codebook_dim"], c["latent_dim"], 3)}
    hs, hd = c["hidden"], c["head_dim"]
    layers = []
    for _ in range(c["layers"]):
        layers.append({
            "input_norm": r.ones(hs), "post_norm": r.ones(hs),
            "q": r.linear(hs, c["heads"] * hd, F32),
            "k": r.linear(hs, c["kv_heads"] * hd, F32),
            "v": r.linear(hs, c["kv_heads"] * hd, F32),
            "o": r.linear(c["heads"] * hd, hs, F32),
            "gate": r.linear(hs, c["intermediate"], F32),
            "up": r.linear(hs, c["intermediate"], F32),
            "down": r.linear(c["intermediate"], hs, F32),
            "ls_attn": r.full(c["layer_scale"], hs),
            "ls_mlp": r.full(c["layer_scale"], hs)})
    p["layers"] = layers
    p["norm"] = r.ones(hs)
    p["input_proj"] = r.linear(c["latent_dim"], hs, F32, bias=True)
    p["output_proj"] = r.linear(hs, c["latent_dim"], F32, bias=True)
    ld = c["latent_dim"]
    p["upsample"] = [{
        "trans": r.tconv(ld, ld, f),
        "dw": r.conv(ld, ld, 7, groups=ld),
        "norm_w": r.ones(ld), "norm_b": r.zeros(ld),
        "pw1": r.linear(ld, 4 * ld, F32, bias=True),
        "pw2": r.linear(4 * ld, ld, F32, bias=True),
        "gamma": r.full(1e-6, ld)} for f in c["upsampling_ratios"]]
    dec = {"conv0": r.conv(ld, c["decoder_dim"], 7), "blocks": []}
    for i, rate in enumerate(c["upsample_rates"]):
        din = c["decoder_dim"] // 2 ** i
        dout = din // 2
        res = [{"a1": r.full(0.0, dout), "b1": r.full(0.0, dout),
                "conv1": r.conv(dout, dout, 7),
                "a2": r.full(0.0, dout), "b2": r.full(0.0, dout),
                "conv2": r.conv(dout, dout, 1)} for _ in (1, 3, 9)]
        dec["blocks"].append({"a": r.full(0.0, din), "b": r.full(0.0, din),
                              "trans": r.tconv(din, dout, 2 * rate),
                              "res": res})
    dout = c["decoder_dim"] // 2 ** len(c["upsample_rates"])
    dec["a_out"], dec["b_out"] = r.full(0.0, dout), r.full(0.0, dout)
    dec["head"] = r.conv(dout, 1, 7)
    p["decoder"] = dec
    return p


# ---------------------------------------------------------------------------
# talker and code predictor
# ---------------------------------------------------------------------------


def prompt_rows(m: dict, text: str, speaker: str = "ryan",
                language: str = "english") -> tuple[list, list, list]:
    """(text ids, codec ids, takes-codec flags) of a CustomVoice prompt."""
    vocab = m["talker"]["text_vocab"]
    role = dev_tokenize("<|im_start|>assistant\n", vocab)[:3]
    rows = [(t, 0, False) for t in role]
    for cid in (CODEC_THINK, CODEC_THINK_BOS, LANGUAGE_IDS[language],
                CODEC_THINK_EOS):
        rows.append((TTS_PAD, cid, True))
    rows.append((TTS_PAD, SPEAKER_IDS[speaker], True))
    rows.append((TTS_BOS, CODEC_PAD, True))
    rows += [(t, CODEC_PAD, True) for t in dev_tokenize(text, vocab)]
    rows.append((TTS_EOS, CODEC_PAD, True))
    rows.append((TTS_PAD, CODEC_BOS, True))
    return ([r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])


class Qwen3Reference:
    def __init__(self, model: dict, seed: int, device,
                 precision: str = "float32"):
        self.m = model
        self.device = torch.device(device)
        self.prec = Precision(precision)
        self.w = make_weights(model, seed, self.device)

    def _embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        w, p = self.w, self.prec
        raw = w["text_embedding"][ids].float()
        return p.linear(w["fc2"], F.silu(p.linear(w["fc1"], raw)))

    def talker_inputs(self, text: str, frames: torch.Tensor
                      ) -> torch.Tensor:
        """(T + n - 1, hidden): the prompt rows, then every served frame
        but the last fed back (text tts_pad + codebook 0's embedding + the
        sum of codebooks 1..15's code-predictor embeddings)."""
        w, dev = self.w, self.device
        txt, cod, needs = prompt_rows(self.m, text)
        txt = torch.tensor(txt, device=dev)
        cod = torch.tensor(cod, device=dev)
        needs = torch.tensor(needs, device=dev)[:, None]
        te = self._embed_text(txt)
        ce = w["codec_embedding"][cod].float()
        x_prompt = torch.where(needs, te + ce, te)
        fed = frames[:-1]
        if fed.shape[0] == 0:
            return x_prompt
        G = self.m["depth"]["codebooks"]
        pad = self._embed_text(torch.full((1,), TTS_PAD, device=dev))
        books = torch.arange(G - 1, device=dev)[None, :]
        fb = w["depth_embeds"][books, fed[:, 1:G].long()].float().sum(1)
        x_gen = pad + w["codec_embedding"][fed[:, 0].long()].float() + fb
        return torch.cat([x_prompt, x_gen], dim=0)

    def _talker_cfg(self) -> dict:
        t = self.m["talker"]
        return {"layers": t["layers"], "heads": t["heads"],
                "kv_heads": t["kv_heads"], "head_dim": t["head_dim"],
                "rope_theta": t["rope_theta"], "eps": t["eps"],
                "qk_norm": True}

    def _depth_cfg(self) -> dict:
        d = self.m["depth"]
        return {"layers": d["layers"], "heads": d["heads"],
                "kv_heads": d["kv_heads"], "head_dim": d["head_dim"],
                "rope_theta": d["rope_theta"], "eps": d["eps"],
                "qk_norm": True}

    def cb0_logits(self, text: str, frames: torch.Tensor):
        """(hidden (n, H), logits (n, vocab)) of codebook 0 at each served
        frame, suppression and repetition penalty applied."""
        t = self.m["talker"]
        x = self.talker_inputs(text, frames)
        T = x.shape[0] - frames.shape[0] + 1
        pos = torch.arange(x.shape[0], device=self.device)
        h = decoder_forward(self.w["talker"], x[None], pos,
                            self._talker_cfg(), self.prec)[0]
        h = h[T - 1:]
        logits = self.prec.mm(h, self.w["codec_head"])
        V = t["vocab"]
        sup = torch.zeros(V, device=self.device)
        sup[V - 1024:] = torch.finfo(F32).min
        sup[CODEC_EOS] = 0.0
        logits = logits + sup
        # repetition penalty over the codebook-0 tokens served before
        seen = torch.zeros_like(logits, dtype=torch.bool)
        n = frames.shape[0]
        prev = F.one_hot(frames[:, 0].long(), V).bool()
        if n > 1:
            seen[1:] = torch.cumsum(prev[:-1].int(), dim=0) > 0
        pen = float(t["repetition_penalty"])
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        return h, torch.where(seen, penalized, logits)

    def depth_logits(self, hidden: torch.Tensor, frames: torch.Tensor
                     ) -> torch.Tensor:
        """(n, 15, vocab): the code predictor's logits of codebooks 1..15
        of each frame, teacher-forced on the served codebooks."""
        w, d, p = self.w, self.m["depth"], self.prec
        G = d["codebooks"]
        n = frames.shape[0]
        inputs = [hidden.float(),
                  w["codec_embedding"][frames[:, 0].long()].float()]
        for i in range(1, G - 1):
            inputs.append(w["depth_embeds"][i - 1][frames[:, i].long()]
                          .float())
        x = torch.stack(inputs, dim=1)                       # (n, G, H)
        x = p.linear(w["depth_proj"], x)
        pos = torch.arange(G, device=self.device)
        h = decoder_forward(w["depth"], x, pos, self._depth_cfg(), p)
        out = []
        for i in range(1, G):
            out.append(p.mm(h[:, i], w["depth_heads"][i - 1]))
        return torch.stack(out, dim=1)

    # ---- codec -------------------------------------------------------------
    def codec_window(self, codes: torch.Tensor, cache: dict | None
                     ) -> tuple[torch.Tensor, dict]:
        """One streamed window: codes (16, L) -> (L * 1920,) float and the
        new cache (``None``: a stream's first window)."""
        return _codec_pipeline(self.w["codec"], self.m["codec"],
                               codes[None], cache, self.prec)

    def decode_stream(self, frames: torch.Tensor, windows: list
                      ) -> torch.Tensor:
        """The PCM the port emits for the audio frames (n, 16) over its
        planned windows [(start, length), ...]."""
        spf = self.m["codec"]["samples_per_frame"]
        cache, out = None, []
        for start, L in windows:
            win = frames[start:start + L]
            valid = win.shape[0]
            if valid == 0:
                continue
            if valid < L:
                win = torch.cat([win, win[-1:].expand(L - valid, -1)], 0)
            wav, cache = self.codec_window(win.T.clamp(0, 2047), cache)
            wav = wav[0, 0]
            if valid < L:
                wav = wav[:max(int(L * spf * (valid - 0.5) / L), 0)]
            out.append(wav)
        return torch.cat(out) if out else torch.zeros(0, device=self.device)

    # ---- judging -----------------------------------------------------------
    @torch.no_grad()
    def judge(self, item: dict, control: "Qwen3Reference | None" = None
              ) -> dict:
        """The numbers of one served request ``item`` (``prompt``,
        ``tokens`` (n, 17) every sampled row, ``windows``, ``pcm`` int16):
        the widest gap of a served codebook-0 token and of a served
        codebook 1..15 token below the reference's best, the served PCM's
        relative error and its length against the reference's. With
        ``control`` (the reference in the lower precision): the same gaps
        of the tokens the control puts first, and the control's PCM
        error."""
        with no_tf32():
            return self._judge(item, control)

    def _judge(self, item: dict, control) -> dict:
        dev = self.device
        G = self.m["depth"]["codebooks"]
        rows = torch.tensor(item["tokens"], device=dev)[:, :G]
        h, l0 = self.cb0_logits(item["prompt"], rows)
        ld = self.depth_logits(h, rows)
        n_audio = item["audio_tokens"]
        out = {"lm_gap": float(widest_gap(l0, rows[:, 0]).max()),
               # a stop row carries no acoustic codebooks to judge
               "depth_gap": float(widest_gap(
                   ld[:n_audio].reshape(-1, ld.shape[-1]),
                   rows[:n_audio, 1:].reshape(-1)).max())
               if n_audio else 0.0}
        ref_pcm = self.decode_stream(rows[:n_audio], item["windows"])
        served = torch.tensor(item["pcm"], device=dev).float() / 32767.0
        ref16 = (ref_pcm.clamp(-1, 1) * 32767.0).trunc() / 32767.0
        out["pcm_len_diff"] = abs(int(served.numel()) - int(ref16.numel()))
        k = min(served.numel(), ref16.numel())
        out["pcm_sq_err"], out["pcm_samples"] = pcm_sums(served[:k],
                                                         ref16[:k])
        if control is not None:
            ch, cl0 = control.cb0_logits(item["prompt"], rows)
            cld = control.depth_logits(ch, rows)
            out["ctl_lm_gap"] = float(widest_gap(l0, cl0.argmax(-1)).max())
            out["ctl_depth_gap"] = float(widest_gap(
                ld[:n_audio].reshape(-1, ld.shape[-1]),
                cld[:n_audio].argmax(-1).reshape(-1)).max()) \
                if n_audio else 0.0
            cpcm = control.decode_stream(rows[:n_audio], item["windows"])
            c16 = (cpcm.clamp(-1, 1) * 32767.0).trunc() / 32767.0
            out["ctl_pcm_sq_err"], _ = pcm_sums(c16[:k], ref16[:k])
        return out


# ---------------------------------------------------------------------------
# the streaming codec decoder (float32)
# ---------------------------------------------------------------------------


def _snake_beta(x, a, b):
    a = torch.exp(a)[None, :, None]
    b = torch.exp(b)[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.square(torch.sin(x * a))


def _causal_conv(prec, p, x, pad, cache, dilation=1, groups=1):
    left = (torch.zeros(x.shape[0], x.shape[1], pad, device=x.device)
            if cache is None else cache)
    xin = torch.cat([left, x], dim=-1)
    return (prec.conv1d(p, xin, dilation=dilation, groups=groups),
            xin[:, :, -pad:] if pad > 0 else left)


def _transconv(prec, p, x, stride, cache):
    """Chunk mode of the causal transposed conv: the previous chunk's last
    input sample prepended, [stride, stride + T * stride) kept."""
    left = (torch.zeros(x.shape[0], x.shape[1], 1, device=x.device)
            if cache is None else cache)
    y = prec.conv_transpose1d(p, torch.cat([left, x], dim=-1), stride)
    T = x.shape[-1]
    return y[:, :, stride:stride + T * stride], x[:, :, -1:]


def _rvq(prec, g, codes):
    embed = g["embed_sum"] / torch.clamp(g["usage"], min=1e-5)[..., None]
    q = embed[torch.arange(embed.shape[0], device=codes.device)[None, :,
                                                                 None],
              codes.long()]
    return prec.conv1d(g["out_proj"], q.sum(dim=1).transpose(1, 2))


def _codec_pipeline(p: dict, c: dict, codes: torch.Tensor,
                    cache: dict | None, prec: Precision):
    """codes (1, 16, T) -> ((1, 1, T * spf), cache), the port's streaming
    decode semantics; ``cache`` None is a fresh stream (zero state)."""
    fresh = cache is None
    cache = cache or {}
    new: dict = {}
    x = _rvq(prec, p["rvq_first"], codes[:, :1]) + _rvq(
        prec, p["rvq_rest"], codes[:, 1:])
    x, new["pre"] = _causal_conv(prec, p["pre_conv"], x, 2,
                                 cache.get("pre"))
    # transformer over the W-slot ring, updated before it is read
    W, hd = c["sliding_window"], c["head_dim"]
    H, KH = c["heads"], c["kv_heads"]
    T = x.shape[-1]
    if T > W:
        raise ValueError(f"a {T}-frame window exceeds the {W}-slot ring")
    dev = x.device
    start = 0 if fresh else cache["pos"]
    pos = torch.arange(start, start + T, device=dev)
    mask = (torch.arange(W, device=dev)[None, :]
            <= (W - T + torch.arange(T, device=dev))[:, None])
    h = prec.linear(p["input_proj"], x.transpose(1, 2))
    ring_k, ring_v = [], []
    for i, lp in enumerate(p["layers"]):
        xin = rms_norm(h, lp["input_norm"], c["eps"])
        q = _rope_codec(prec.linear(lp["q"], xin).reshape(1, T, H, hd), pos,
                        c["rope_theta"])
        k = _rope_codec(prec.linear(lp["k"], xin).reshape(1, T, KH, hd), pos,
                        c["rope_theta"])
        v = prec.linear(lp["v"], xin).reshape(1, T, KH, hd)
        old_k = (torch.zeros(1, W, KH, hd, device=dev) if fresh
                 else cache["k"][i])
        old_v = (torch.zeros(1, W, KH, hd, device=dev) if fresh
                 else cache["v"][i])
        k_all = torch.cat([old_k, k], dim=1)[:, -W:]
        v_all = torch.cat([old_v, v], dim=1)[:, -W:]
        ring_k.append(k_all)
        ring_v.append(v_all)
        a = attention(q, k_all, v_all, mask).reshape(1, T, H * hd)
        h = h + lp["ls_attn"] * prec.linear(lp["o"], a)
        xin = rms_norm(h, lp["post_norm"], c["eps"])
        h = h + lp["ls_mlp"] * prec.linear(
            lp["down"], F.silu(prec.linear(lp["gate"], xin))
            * prec.linear(lp["up"], xin))
    h = rms_norm(h, p["norm"], c["eps"])
    x = prec.linear(p["output_proj"], h).transpose(1, 2)
    new.update(k=ring_k, v=ring_v, pos=start + T)
    for i, (st, f) in enumerate(zip(p["upsample"], c["upsampling_ratios"])):
        x, new[f"up{i}"] = _transconv(prec, st["trans"], x, f,
                                      cache.get(f"up{i}"))
        res = x
        y, new[f"dw{i}"] = _causal_conv(prec, st["dw"], x, 6,
                                        cache.get(f"dw{i}"),
                                        groups=x.shape[1])
        y = layer_norm(y.transpose(1, 2), st["norm_w"], st["norm_b"], 1e-6)
        y = prec.linear(st["pw2"], F.gelu(prec.linear(st["pw1"], y)))
        x = res + (st["gamma"] * y).transpose(1, 2)
    dec = p["decoder"]
    x, new["c0"] = _causal_conv(prec, dec["conv0"], x, 6, cache.get("c0"))
    for i, (b, rate) in enumerate(zip(dec["blocks"], c["upsample_rates"])):
        x = _snake_beta(x, b["a"], b["b"])
        x, new[f"bt{i}"] = _transconv(prec, b["trans"], x, rate,
                                      cache.get(f"bt{i}"))
        for j, dil in enumerate((1, 3, 9)):
            rp = b["res"][j]
            y = _snake_beta(x, rp["a1"], rp["b1"])
            y, new[f"r{i}{j}"] = _causal_conv(prec, rp["conv1"], y, 6 * dil,
                                              cache.get(f"r{i}{j}"),
                                              dilation=dil)
            y = _snake_beta(y, rp["a2"], rp["b2"])
            x = x + prec.conv1d(rp["conv2"], y)
    x = _snake_beta(x, dec["a_out"], dec["b_out"])
    x, new["head"] = _causal_conv(prec, dec["head"], x, 6, cache.get("head"))
    return torch.clamp(x, -1.0, 1.0), new


def _rope_codec(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32, device=x.device)
                          / d)
    ang = pos.float()[:, None] * inv[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_dims(m: dict) -> dict:
    """The talker's attention shape, which K1 and K3 serve."""
    t = m["talker"]
    return {"heads": t["heads"], "kv_heads": t["kv_heads"],
            "head_dim": t["head_dim"], "layers": t["layers"]}


def decode_flops(m: dict, rows: int, keys: int) -> float:
    """Model FLOPs of ``rows`` served decode rows of Qwen3-TTS that read
    ``keys`` KV positions in all: per row the talker's matrix products
    (the text projection of the fed row included), the codebook-0 head and
    the code predictor's 16 positions with its 15 heads; attention over
    the keys."""
    t = m["talker"]
    H = t["hidden"]
    per_row = (2 * t["layers"] * _layer_params(t) + 4 * H * H
               + 2 * H * t["vocab"] + depth_flops(m))
    return (rows * per_row
            + 4.0 * t["layers"] * t["heads"] * t["head_dim"] * keys)


def depth_flops(m: dict) -> float:
    t, d = m["talker"], m["depth"]
    G = d["codebooks"]
    f = 2 * G * t["hidden"] * d["hidden"]            # input projection
    f += 2 * G * d["layers"] * _layer_params(d)
    f += 4 * d["layers"] * d["heads"] * d["head_dim"] * sum(
        range(1, G + 1))
    f += 2 * (G - 1) * d["hidden"] * d["vocab"]
    return f


def prefill_flops(m: dict, tokens: int, pairs: int, rows: int) -> float:
    """Model FLOPs of a prefill of ``rows`` prompts with ``tokens`` prompt
    tokens and ``pairs`` causal (query, key) pairs: the talker over every
    token, the head and the code predictor once per prompt."""
    t = m["talker"]
    H = t["hidden"]
    f = tokens * (2 * t["layers"] * _layer_params(t) + 4 * H * H)
    f += 4 * t["layers"] * t["heads"] * t["head_dim"] * pairs
    return f + rows * (2 * H * t["vocab"] + depth_flops(m))


def _layer_params(s: dict) -> int:
    """Matrix parameters of one decoder layer (q, k, v, o, gate, up,
    down)."""
    H, D = s["hidden"], s["head_dim"]
    return (H * s["heads"] * D * 2 + H * s["kv_heads"] * D * 2
            + 3 * H * s["intermediate"])




def make_reference(model: dict, seed: int, device,
                   precision: str = "float32") -> Qwen3Reference:
    return Qwen3Reference(model, seed, device, precision)
