"""Synthetic checkpoints in the published layouts, for the port's loaders.

No published weights can be fetched where this repository is tested, so
the loaders are held to checkpoints made from the port's own parameter
trees (random weights from a seed, at any width): each ``export_*`` here is
the inverse of a mapper of ``vox_serve_tpu_torch`` (``weights.py``,
``codecs/``, ``encoders/``, ``watermark/silentcipher.py``, the models) and
returns ``{published tensor name: tensor}`` (HF ``(out, in)`` linear
layouts, per-layer and per-codebook tensors unstacked). ``write_onnx``
writes the ONNX-only checkpoints (CosyVoice2's S3 v2 tokenizer and
CAMPPlus) with a minimal protobuf writer of its own. The tests check the
exporters by having the JAX package's loaders read their output back to the
same tree; ``chip_smoke.py`` writes full-width snapshots with them into a
temporary Hugging Face hub cache and holds every tensor the port loads on
the card bit-equal to the one it wrote.

Not part of the package: nothing the port serves imports this module.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# writing snapshots
# ---------------------------------------------------------------------------


def snapshot_dir(cache: Path, model_id: str,
                 commit: str = "0123456789abcdef0123456789abcdef01234567"
                 ) -> Path:
    """Create ``models--{org}--{name}/refs/main`` naming ``commit`` in a hub
    cache and return the (new, empty) ``snapshots/<commit>/`` directory."""
    repo = Path(cache) / ("models--" + model_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True, exist_ok=True)
    (repo / "refs" / "main").write_text(commit)
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True, exist_ok=True)
    return snap


def write_shards(directory: Path, state: dict, n_shards: int = 2,
                 stem: str = "model") -> int:
    """Write ``state`` as ``n_shards`` safetensors files (names sorted and
    split into contiguous runs) with the port's writer; returns bytes."""
    from vox_serve_tpu_torch.weights import save_safetensors

    names = sorted(state)
    cuts = np.linspace(0, len(names), n_shards + 1).astype(int)
    total = 0
    for i in range(n_shards):
        part = {k: state[k] for k in names[cuts[i]:cuts[i + 1]]}
        total += save_safetensors(
            part, Path(directory)
            / f"{stem}-{i + 1:05d}-of-{n_shards:05d}.safetensors")
    return total


# ---------------------------------------------------------------------------
# exporters (the inverse of the port's mappers)
# ---------------------------------------------------------------------------


def _t(w: torch.Tensor) -> torch.Tensor:
    """(d_in, d_out) -> the HF (out, in) layout."""
    return w.T.contiguous()


def _cast(state: dict, dtype: Optional[torch.dtype]) -> dict:
    if dtype is None:
        return state
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in state.items()}


def export_llama_backbone(bb: dict, prefix: str) -> dict:
    """Inverse of ``load_llama_family_backbone``."""
    L = bb["layers"]["input_norm"].shape[0]
    attn, mlp = bb["layers"]["attn"], bb["layers"]["mlp"]
    out = {prefix + "norm.weight": bb["final_norm"]}
    for i in range(L):
        p = f"{prefix}layers.{i}."
        for name, lin in (("self_attn.q_proj", attn["q"]),
                          ("self_attn.k_proj", attn["k"]),
                          ("self_attn.v_proj", attn["v"]),
                          ("self_attn.o_proj", attn["o"]),
                          ("mlp.gate_proj", mlp["gate"]),
                          ("mlp.up_proj", mlp["up"]),
                          ("mlp.down_proj", mlp["down"])):
            out[p + name + ".weight"] = _t(lin["w"][i])
            if "b" in lin:
                out[p + name + ".bias"] = lin["b"][i]
        if "q_norm" in attn:
            out[p + "self_attn.q_norm.weight"] = attn["q_norm"][i]
            out[p + "self_attn.k_norm.weight"] = attn["k_norm"][i]
        out[p + "input_layernorm.weight"] = bb["layers"]["input_norm"][i]
        out[p + "post_attention_layernorm.weight"] = (
            bb["layers"]["post_norm"][i])
    return out


def export_qwen3(params: dict, spk_enc: Optional[dict] = None,
                 spk_dtype: Optional[torch.dtype] = None) -> dict:
    """Inverse of ``Qwen3TTSLM._load_checkpoint``: the talker, the depth
    predictor and, for the Base variant, ``speaker_encoder.*`` (cast to
    ``spk_dtype``, as the published checkpoint stores it in bf16)."""
    t, cp = "talker.model.", "talker.code_predictor."
    d = params["depth"]
    out = export_llama_backbone(params["backbone"], t)
    out.update(export_llama_backbone(d["backbone"], cp + "model."))
    out[t + "codec_embedding.weight"] = params["codec_embedding"]
    out[t + "text_embedding.weight"] = params["text_embedding"]
    for i in (1, 2):
        fc = params["text_projection"][f"fc{i}"]
        out[f"talker.text_projection.linear_fc{i}.weight"] = _t(fc["w"])
        out[f"talker.text_projection.linear_fc{i}.bias"] = fc["b"]
    out["talker.codec_head.weight"] = _t(params["codec_head"])
    out[cp + "small_to_mtp_projection.weight"] = _t(d["proj"]["w"])
    out[cp + "small_to_mtp_projection.bias"] = d["proj"]["b"]
    for i in range(d["embeds"].shape[0]):
        out[cp + f"model.codec_embedding.{i}.weight"] = d["embeds"][i]
        out[cp + f"lm_head.{i}.weight"] = _t(d["heads"][i])
    if spk_enc is not None:
        out.update(_cast(export_ecapa(spk_enc, "speaker_encoder."),
                         spk_dtype))
    return out


def export_ecapa(p: dict, prefix: str = "speaker_encoder.") -> dict:
    """Inverse of ``load_ecapa_params``."""
    out: dict = {}

    def conv(name, c):
        _conv(out, prefix + name, c)

    conv("blocks.0.conv", p["blocks"][0]["conv"])
    for i, b in enumerate(p["blocks"][1:], start=1):
        pre = f"blocks.{i}"
        conv(f"{pre}.tdnn1.conv", b["tdnn1"]["conv"])
        for j, r in enumerate(b["res2net"]["blocks"]):
            conv(f"{pre}.res2net_block.blocks.{j}.conv", r["conv"])
        conv(f"{pre}.tdnn2.conv", b["tdnn2"]["conv"])
        conv(f"{pre}.se_block.conv1", b["se"]["conv1"])
        conv(f"{pre}.se_block.conv2", b["se"]["conv2"])
    conv("mfa.conv", p["mfa"]["conv"])
    conv("asp.tdnn.conv", p["asp"]["tdnn"]["conv"])
    conv("asp.conv", p["asp"]["conv"])
    conv("fc", p["fc"])
    return out


def _conv(out: dict, name: str, c: dict) -> None:
    out[name + ".weight"] = c["w"]
    if "b" in c:
        out[name + ".bias"] = c["b"]


def _lin(out: dict, name: str, c: dict) -> None:
    out[name + ".weight"] = _t(c["w"])
    if "b" in c:
        out[name + ".bias"] = c["b"]


def export_qwen3_codec(codec: dict, prefix: str = "decoder.") -> dict:
    """Inverse of ``load_qwen3_codec_params`` (the full codec model's
    ``decoder.`` names)."""
    out: dict = {}
    p = prefix
    for g in ("rvq_first", "rvq_rest"):
        grp = codec[g]
        for i in range(grp["embed_sum"].shape[0]):
            cb = f"{p}quantizer.{g}.vq.layers.{i}._codebook"
            out[cb + ".embedding_sum"] = grp["embed_sum"][i]
            out[cb + ".cluster_usage"] = grp["usage"][i]
        out[f"{p}quantizer.{g}.output_proj.weight"] = grp["out_proj"]["w"]
    _conv(out, p + "pre_conv.conv", codec["pre_conv"])
    tr = codec["transformer"]
    for i, lp in enumerate(tr["layers"]):
        pre = f"{p}pre_transformer.layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = lp["input_norm"]
        out[f"{pre}.post_attention_layernorm.weight"] = lp["post_norm"]
        for k in ("q", "k", "v", "o"):
            _lin(out, f"{pre}.self_attn.{k}_proj", lp[k])
        for k in ("gate", "up", "down"):
            _lin(out, f"{pre}.mlp.{k}_proj", lp[k])
        out[f"{pre}.self_attn_layer_scale.scale"] = lp["ls_attn"]
        out[f"{pre}.mlp_layer_scale.scale"] = lp["ls_mlp"]
    out[p + "pre_transformer.norm.weight"] = tr["norm"]
    _lin(out, p + "pre_transformer.input_proj", tr["input_proj"])
    _lin(out, p + "pre_transformer.output_proj", tr["output_proj"])
    for i, up in enumerate(codec["upsample"]):
        pre = f"{p}upsample.{i}"
        _conv(out, f"{pre}.0.conv", up["trans"])
        cn = up["convnext"]
        _conv(out, f"{pre}.1.dwconv.conv", cn["dw"])
        out[f"{pre}.1.norm.weight"] = cn["norm_w"]
        out[f"{pre}.1.norm.bias"] = cn["norm_b"]
        _lin(out, f"{pre}.1.pwconv1", cn["pw1"])
        _lin(out, f"{pre}.1.pwconv2", cn["pw2"])
        out[f"{pre}.1.gamma"] = cn["gamma"]
    dec = codec["decoder"]
    _conv(out, p + "decoder.0.conv", dec["conv0"])
    for i, b in enumerate(dec["blocks"]):
        pre = f"{p}decoder.{i + 1}.block"
        out[f"{pre}.0.alpha"] = b["alpha"]
        out[f"{pre}.0.beta"] = b["beta"]
        _conv(out, f"{pre}.1.conv", b["trans"])
        for j, r in enumerate(b["res"]):
            rp = f"{pre}.{j + 2}"
            out[f"{rp}.act1.alpha"] = r["alpha1"]
            out[f"{rp}.act1.beta"] = r["beta1"]
            _conv(out, f"{rp}.conv1.conv", r["conv1"])
            out[f"{rp}.act2.alpha"] = r["alpha2"]
            out[f"{rp}.act2.beta"] = r["beta2"]
            _conv(out, f"{rp}.conv2.conv", r["conv2"])
    n = len(dec["blocks"])
    out[f"{p}decoder.{n + 1}.alpha"] = dec["alpha_out"]
    out[f"{p}decoder.{n + 1}.beta"] = dec["beta_out"]
    _conv(out, f"{p}decoder.{n + 2}.conv", dec["head"])
    return out


_SEM, _AC = ("semantic_residual_vector_quantizer",
             "acoustic_residual_vector_quantizer")


def _mimi_transformer(out: dict, name: str, layers: list) -> None:
    for i, lp in enumerate(layers):
        pre = f"{name}.layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = lp["ln1_w"]
        out[f"{pre}.input_layernorm.bias"] = lp["ln1_b"]
        out[f"{pre}.post_attention_layernorm.weight"] = lp["ln2_w"]
        out[f"{pre}.post_attention_layernorm.bias"] = lp["ln2_b"]
        for k in ("q", "k", "v", "o"):
            _lin(out, f"{pre}.self_attn.{k}_proj", lp[k])
        _lin(out, f"{pre}.mlp.fc1", lp["fc1"])
        _lin(out, f"{pre}.mlp.fc2", lp["fc2"])
        out[f"{pre}.self_attn_layer_scale.scale"] = lp["ls_attn"]
        out[f"{pre}.mlp_layer_scale.scale"] = lp["ls_mlp"]


def _mimi_codebooks(out: dict, prefix: str, vq: dict) -> None:
    for name, g in ((_SEM, vq["rvq_first"]), (_AC, vq["rvq_rest"])):
        for i in range(g["embed_sum"].shape[0]):
            cb = f"{prefix}quantizer.{name}.layers.{i}.codebook"
            out[cb + ".embed_sum"] = g["embed_sum"][i]
            out[cb + ".cluster_usage"] = g["usage"][i]


def export_mimi(dec: dict, prefix: str = "") -> dict:
    """Inverse of ``load_mimi_params`` (the decode path)."""
    out: dict = {}
    _mimi_codebooks(out, prefix, dec)
    out[f"{prefix}quantizer.{_SEM}.output_proj.weight"] = (
        dec["rvq_first"]["out_proj"]["w"])
    out[f"{prefix}quantizer.{_AC}.output_proj.weight"] = (
        dec["rvq_rest"]["out_proj"]["w"])
    _mimi_transformer(out, prefix + "decoder_transformer",
                      dec["transformer"]["layers"])
    _conv(out, prefix + "upsample.conv", dec["upsample_trans"])
    _conv(out, prefix + "decoder.layers.0.conv", dec["dec_conv0"])
    for i, b in enumerate(dec["blocks"]):
        _conv(out, f"{prefix}decoder.layers.{2 + 3 * i}.conv", b["trans"])
        _conv(out, f"{prefix}decoder.layers.{3 + 3 * i}.block.1.conv",
              b["res_conv1"])
        _conv(out, f"{prefix}decoder.layers.{3 + 3 * i}.block.3.conv",
              b["res_conv2"])
    _conv(out, f"{prefix}decoder.layers.{2 + 3 * len(dec['blocks'])}.conv",
          dec["head"])
    return out


def export_mimi_encoder(enc: dict, prefix: str = "") -> dict:
    """Inverse of ``load_mimi_encoder_params`` (the encode path with its
    quantizer's input projections and codebooks)."""
    out: dict = {}
    _conv(out, prefix + "encoder.layers.0.conv", enc["enc_conv0"])
    for j, b in enumerate(enc["enc_blocks"]):
        _conv(out, f"{prefix}encoder.layers.{1 + 3 * j}.block.1.conv",
              b["res_conv1"])
        _conv(out, f"{prefix}encoder.layers.{1 + 3 * j}.block.3.conv",
              b["res_conv2"])
        _conv(out, f"{prefix}encoder.layers.{3 + 3 * j}.conv", b["down"])
    n = len(enc["enc_blocks"])
    _conv(out, f"{prefix}encoder.layers.{2 + 3 * n}.conv", enc["enc_final"])
    _mimi_transformer(out, prefix + "encoder_transformer",
                      enc["enc_transformer"]["layers"])
    _conv(out, prefix + "downsample.conv", enc["downsample"])
    out[f"{prefix}quantizer.{_SEM}.input_proj.weight"] = (
        enc["in_proj_first"]["w"])
    out[f"{prefix}quantizer.{_AC}.input_proj.weight"] = (
        enc["in_proj_rest"]["w"])
    _mimi_codebooks(out, prefix, enc)
    return out


def share_mimi_codebooks(dec: dict, enc: dict) -> dict:
    """A plain Mimi checkpoint stores one set of codebooks for encode and
    decode: ``enc`` with the decoder's codebooks (what its loader reads
    back)."""
    return {**enc,
            "rvq_first": {k: dec["rvq_first"][k] for k in ("embed_sum",
                                                           "usage")},
            "rvq_rest": {k: dec["rvq_rest"][k] for k in ("embed_sum",
                                                         "usage")}}


def export_csm(params: dict, codec: Optional[dict] = None,
               encoder: Optional[dict] = None,
               codec_dtype: Optional[torch.dtype] = None) -> dict:
    """Inverse of ``CSMLM._load_checkpoint``: the transformers
    ``CsmForConditionalGeneration`` names, with the Mimi codec (decoder
    and encoder, sharing the decoder's codebooks) under ``codec_model.``
    cast to ``codec_dtype``."""
    d = params["depth"]
    out = export_llama_backbone(params["backbone"], "backbone_model.")
    out.update(export_llama_backbone(d["backbone"], "depth_decoder.model."))
    out["backbone_model.embed_tokens.embed_audio_tokens.weight"] = (
        params["audio_embed"])
    out["embed_text_tokens.weight"] = params["text_embed"]
    out["lm_head.weight"] = _t(params["lm_head"])
    out["depth_decoder.model.inputs_embeds_projector.weight"] = (
        _t(d["proj"]["w"]))
    out["depth_decoder.model.embed_tokens.weight"] = d["embeds"]
    out["depth_decoder.codebooks_head.weight"] = d["heads"]
    if codec is not None:
        mimi = export_mimi(codec, "codec_model.")
        if encoder is not None:
            mimi.update(export_mimi_encoder(
                share_mimi_codebooks(codec, encoder), "codec_model."))
        out.update(_cast(mimi, codec_dtype))
    return out


def export_orpheus(params: dict, tied: bool = False) -> dict:
    """Inverse of ``OrpheusLM._load_params``; ``tied`` leaves out
    ``lm_head.weight`` (the loader then ties the head to the embedding)."""
    out = export_llama_backbone(params["backbone"], "model.")
    out["model.embed_tokens.weight"] = params["embed"]
    if not tied:
        out["lm_head.weight"] = _t(params["head"])
    return out


def weight_norm_pair(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight_g, weight_v) with v = w and g its per-output-channel norm,
    computed as ``fold_weight_norm`` computes it, so the fold gives w back
    bit for bit."""
    v = w.detach().float().cpu().numpy()
    g = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)
    return (torch.from_numpy(g.reshape([-1] + [1] * (v.ndim - 1))),
            torch.from_numpy(v))


def export_snac(params: dict, cfg) -> dict:
    """Inverse of ``load_snac_params`` in the published snac_24khz layout:
    weight-normed convs as ``weight_g`` / ``weight_v``."""
    out: dict = {}

    def wn(name, c):
        out[name + ".weight_g"], out[name + ".weight_v"] = (
            weight_norm_pair(c["w"]))
        if "b" in c:
            out[name + ".bias"] = c["b"]

    for i, q in enumerate(params["quantizers"]):
        out[f"quantizer.quantizers.{i}.codebook.weight"] = q["codebook"]
        wn(f"quantizer.quantizers.{i}.out_proj", q["out_proj"])
    dec, d = params["decoder"], "decoder.model"
    if cfg.depthwise:
        wn(f"{d}.0", dec["stem_dw"])
        wn(f"{d}.1", dec["stem_pw"])
        base = 2
    else:
        wn(f"{d}.0", dec["stem"])
        base = 1
    if cfg.attn_window_size:
        base += 1
    for i, b in enumerate(dec["blocks"]):
        pre = f"{d}.{base + i}.block"
        out[f"{pre}.0.alpha"] = b["alpha_in"]
        wn(f"{pre}.1", b["up"])
        res_start = 2
        if cfg.noise:
            wn(f"{pre}.2.linear", b["noise"])
            res_start = 3
        for j, r in enumerate(b["res"]):
            rp = f"{pre}.{res_start + j}.block"
            out[f"{rp}.0.alpha"] = r["alpha1"]
            wn(f"{rp}.1", r["conv1"])
            out[f"{rp}.2.alpha"] = r["alpha2"]
            wn(f"{rp}.3", r["conv2"])
    n = base + len(dec["blocks"])
    out[f"{d}.{n}.alpha"] = dec["alpha_out"]
    wn(f"{d}.{n + 1}", dec["head"])
    return out


def export_silentcipher(params: dict) -> dict:
    """Inverse of ``load_silentcipher_params``: {file name: state dict}
    for ``enc_c.ckpt`` / ``dec_c.ckpt`` / ``dec_m_0.ckpt``, with the
    ``module.`` prefix and the batch-norm counters a DataParallel
    checkpoint carries."""
    def gated(layers):
        sd = {}
        for i, g in enumerate(layers):
            p = f"module.main.{i}."
            sd[p + "conv.weight"] = g["conv"]["w"]
            sd[p + "conv.bias"] = g["conv"]["b"]
            sd[p + "gate.weight"] = g["gate"]["w"]
            sd[p + "gate.bias"] = g["gate"]["b"]
            sd[p + "bn.weight"] = g["bn_w"]
            sd[p + "bn.bias"] = g["bn_b"]
            sd[p + "bn.running_mean"] = g["bn_mean"]
            sd[p + "bn.running_var"] = g["bn_var"]
            sd[p + "bn.num_batches_tracked"] = torch.tensor(0)
        return sd

    def linear(lin):
        return {"module.linear.weight": _t(lin["w"]),
                "module.linear.bias": lin["b"]}

    return {
        "enc_c.ckpt": {**gated(params["enc_c"]["main"]),
                       **linear(params["enc_c"]["linear"])},
        "dec_c.ckpt": gated(params["dec_c"]["main"]),
        "dec_m_0.ckpt": {**gated(params["dec_m"]["main"]),
                         **linear(params["dec_m"]["linear"])},
    }


def write_silentcipher(snapshot: Path, params: dict, cfg) -> int:
    """The sony/silentcipher layout: ``44_1_khz/73999_iteration/`` with the
    three torch state dicts and a flat ``hparams.yaml``; returns bytes."""
    ckpt = Path(snapshot) / "44_1_khz" / "73999_iteration"
    ckpt.mkdir(parents=True, exist_ok=True)
    for name, sd in export_silentcipher(params).items():
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   ckpt / name)
    (ckpt / "hparams.yaml").write_text(
        f"SR: {cfg.sr}\nN_FFT: {cfg.n_fft}\nHOP_LENGTH: {cfg.hop}\n"
        f"message_dim: {cfg.message_dim}\nmessage_len: {cfg.message_len}\n"
        f"message_band_size: {cfg.message_band_size}\n"
        f"message_sdr: {cfg.message_sdr}\n"
        f"frame_level_normalization: "
        f"{str(cfg.frame_level_normalization).lower()}\n")
    return sum(os.path.getsize(ckpt / f) for f in os.listdir(ckpt))


# ---------------------------------------------------------------------------
# CosyVoice2 (FunAudioLLM/CosyVoice2-0.5B)
# ---------------------------------------------------------------------------


def _ln(out: dict, name: str, p: dict) -> None:
    out[name + ".weight"] = p["w"]
    out[name + ".bias"] = p["b"]


def export_cosy_encoder_section(params: dict) -> dict:
    """Inverse of ``load_cosy_encoder_section``: the input embedding, the
    speaker affine, the upsample conformer encoder and ``encoder_proj``
    (one key layout in CosyVoice2's and Step-Audio 2's ``flow.pt``)."""
    out: dict = {}

    def conformer(pre, p):
        a = p["self_attn"]
        for n in ("linear_q", "linear_k", "linear_v", "linear_out",
                  "linear_pos"):
            _lin(out, f"{pre}.self_attn.{n}", a[n])
        out[f"{pre}.self_attn.pos_bias_u"] = a["pos_bias_u"]
        out[f"{pre}.self_attn.pos_bias_v"] = a["pos_bias_v"]
        _lin(out, f"{pre}.feed_forward.w_1", p["feed_forward"]["w_1"])
        _lin(out, f"{pre}.feed_forward.w_2", p["feed_forward"]["w_2"])
        _ln(out, f"{pre}.norm_mha", p["norm_mha"])
        _ln(out, f"{pre}.norm_ff", p["norm_ff"])

    out["input_embedding.weight"] = params["input_embedding"]
    _lin(out, "spk_embed_affine_layer", params["spk_embed_affine_layer"])
    enc = params["encoder"]
    _lin(out, "encoder.embed.out.0", enc["embed_out"])
    _ln(out, "encoder.embed.out.1", enc["embed_norm"])
    _lin(out, "encoder.up_embed.out.0", enc["up_embed_out"])
    _ln(out, "encoder.up_embed.out.1", enc["up_embed_norm"])
    for n in ("conv1", "conv2"):
        _conv(out, f"encoder.pre_lookahead_layer.{n}",
              enc["pre_lookahead"][n])
    for i, p in enumerate(enc["encoders"]):
        conformer(f"encoder.encoders.{i}", p)
    _conv(out, "encoder.up_layer.conv", enc["up_layer_conv"])
    for i, p in enumerate(enc["up_encoders"]):
        conformer(f"encoder.up_encoders.{i}", p)
    _ln(out, "encoder.after_norm", enc["after_norm"])
    _lin(out, "encoder_proj", params["encoder_proj"])
    return out


def export_cosy_flow(params: dict) -> dict:
    """Inverse of ``load_cosy_flow_params``: ``flow.pt``'s names
    (``CausalMaskedDiffWithXvec.state_dict()``)."""
    out = export_cosy_encoder_section(params)

    def causal_block(pre, p):
        _conv(out, f"{pre}.block.0", p["conv"])
        _ln(out, f"{pre}.block.2", p["norm"])

    def causal_resnet(pre, p):
        _lin(out, f"{pre}.mlp.1", p["mlp"])
        causal_block(f"{pre}.block1", p["block1"])
        causal_block(f"{pre}.block2", p["block2"])
        _conv(out, f"{pre}.res_conv", p["res_conv"])

    def est_block(pre, p):
        _ln(out, f"{pre}.norm1", p["norm1"])
        for n in ("to_q", "to_k", "to_v"):
            _lin(out, f"{pre}.attn1.{n}", p["attn1"][n])
        _lin(out, f"{pre}.attn1.to_out.0", p["attn1"]["to_out"])
        _ln(out, f"{pre}.norm3", p["norm3"])
        _lin(out, f"{pre}.ff.net.0.proj", p["ff"]["proj"])
        _lin(out, f"{pre}.ff.net.2", p["ff"]["out"])

    e, est = "decoder.estimator", params["estimator"]
    _lin(out, f"{e}.time_mlp.linear_1", est["time_mlp"]["linear_1"])
    _lin(out, f"{e}.time_mlp.linear_2", est["time_mlp"]["linear_2"])
    d0 = est["down"][0]
    causal_resnet(f"{e}.down_blocks.0.0", d0["resnet"])
    for j, b in enumerate(d0["blocks"]):
        est_block(f"{e}.down_blocks.0.1.{j}", b)
    _conv(out, f"{e}.down_blocks.0.2", d0["downsample"])
    for i, m in enumerate(est["mid"]):
        causal_resnet(f"{e}.mid_blocks.{i}.0", m["resnet"])
        for j, b in enumerate(m["blocks"]):
            est_block(f"{e}.mid_blocks.{i}.1.{j}", b)
    u0 = est["up"][0]
    causal_resnet(f"{e}.up_blocks.0.0", u0["resnet"])
    for j, b in enumerate(u0["blocks"]):
        est_block(f"{e}.up_blocks.0.1.{j}", b)
    _conv(out, f"{e}.up_blocks.0.2", u0["upsample"])
    causal_block(f"{e}.final_block", est["final_block"])
    _conv(out, f"{e}.final_proj", est["final_proj"])
    return out


def export_hift(params: dict, prefix: str = "generator.") -> dict:
    """Inverse of ``load_hift_params`` in ``hift.pt``'s layout: the
    weight-normed convs as parametrized ``original0`` / ``original1``
    pairs, every name under ``prefix`` (the published file's
    ``generator.``, which the model strips)."""
    out: dict = {}

    def wn(name, c):
        g, v = weight_norm_pair(c["w"])
        out[prefix + name + ".parametrizations.weight.original0"] = g
        out[prefix + name + ".parametrizations.weight.original1"] = v
        if "b" in c:
            out[prefix + name + ".bias"] = c["b"]

    def conv(name, c):
        _conv(out, prefix + name, c)

    def resblock(name, r):
        for j in range(len(r["convs1"])):
            wn(f"{name}.convs1.{j}", r["convs1"][j])
            wn(f"{name}.convs2.{j}", r["convs2"][j])
            out[f"{prefix}{name}.activations1.{j}.alpha"] = (
                r["alpha1"][j].reshape(1, -1, 1))
            out[f"{prefix}{name}.activations2.{j}.alpha"] = (
                r["alpha2"][j].reshape(1, -1, 1))

    for i, c in enumerate(params["f0_convs"]):
        wn(f"f0_predictor.condnet.{2 * i}", c)
    out[prefix + "f0_predictor.classifier.weight"] = _t(params["f0_out_w"])
    out[prefix + "f0_predictor.classifier.bias"] = params["f0_out_b"]
    out[prefix + "m_source.l_linear.weight"] = _t(params["source_linear_w"])
    out[prefix + "m_source.l_linear.bias"] = params["source_linear_b"]
    wn("conv_pre", params["conv_pre"])
    for i, c in enumerate(params["ups"]):
        wn(f"ups.{i}", c)
    for i, c in enumerate(params["source_downs"]):
        conv(f"source_downs.{i}", c)
    for i, r in enumerate(params["source_resblocks"]):
        resblock(f"source_resblocks.{i}", r)
    for i, r in enumerate(params["resblocks"]):
        resblock(f"resblocks.{i}", r)
    wn("conv_post", params["conv_post"])
    return out


def export_cosy_lm(params: dict, text_embed: torch.Tensor) -> dict:
    """Inverse of ``CosyVoice2LM._load_lm``: the Qwen2 layers under
    ``model.*`` (q/k/v biases), ``model.embed_tokens.weight`` (the text
    table), and the speech tables and head (``speech_embedding``,
    ``llm_embedding``, ``llm_decoder``)."""
    out = export_llama_backbone(params["backbone"], "model.")
    out["model.embed_tokens.weight"] = text_embed
    out["speech_embedding.weight"] = params["speech_embed"]
    out["llm_embedding.weight"] = params["llm_embed"]
    out["llm_decoder.weight"] = _t(params["head"])
    return out


def export_s3v2(params: dict) -> dict:
    """Inverse of ``load_s3v2_params`` (``speech_tokenizer_v2``'s names;
    its linear weights are already ``(out, in)``)."""
    out = {"encoder.conv1.weight": params["conv1"]["w"],
           "encoder.conv1.bias": params["conv1"]["b"],
           "encoder.conv2.weight": params["conv2"]["w"],
           "encoder.conv2.bias": params["conv2"]["b"]}
    for i, lp in enumerate(params["layers"]):
        pre = f"encoder.blocks.{i}"
        for name, key in (("attn.query", "q"), ("attn.key", "k"),
                          ("attn.value", "v"), ("attn.out", "o"),
                          ("mlp.0", "fc1"), ("mlp.2", "fc2")):
            _conv(out, f"{pre}.{name}", lp[key])
        out[f"{pre}.attn.fsmn_block.weight"] = lp["fsmn_w"]
        out[f"{pre}.attn_ln.weight"] = lp["ln1_w"]
        out[f"{pre}.attn_ln.bias"] = lp["ln1_b"]
        out[f"{pre}.mlp_ln.weight"] = lp["ln2_w"]
        out[f"{pre}.mlp_ln.bias"] = lp["ln2_b"]
    _conv(out, "quantizer._codebook.project_down", params["fsq_proj"])
    return out


def campplus_state(generator: torch.Generator, feat_dim: int = 80,
                   m_channels: int = 32, embed_dim: int = 192) -> dict:
    """A random CAMPPlus state dict at the published widths and names
    (``campplus.onnx``'s initializers): the FCM head (32 channels, two
    2-block residual stages), the TDNN stem (-> 128), the three CAM dense
    blocks (12 / 24 / 16 layers, growth 32, bottleneck 128) with their
    transits (-> 256, 512, 512), and the dense layer to ``embed_dim``.
    Batch norms carry running statistics; weights are drawn at a fan-in
    scale so that activations stay O(1)."""
    from vox_serve_tpu_torch.encoders.campplus import (BLOCK_SPECS, BN_SIZE,
                                                       GROWTH, INIT_CHANNELS)

    sd: dict = {}

    def w(name, shape):
        fan_in = int(np.prod(shape[1:]))
        sd[name] = torch.randn(shape, generator=generator) / fan_in ** 0.5

    def b(name, n):
        sd[name] = torch.randn((n,), generator=generator) * 0.02

    def bn(name, n, affine=True):
        sd[name + ".running_mean"] = torch.randn((n,), generator=generator
                                                 ) * 0.1
        sd[name + ".running_var"] = 0.5 + torch.rand((n,),
                                                     generator=generator)
        if affine:
            sd[name + ".weight"] = 1.0 + 0.1 * torch.randn(
                (n,), generator=generator)
            sd[name + ".bias"] = 0.1 * torch.randn((n,), generator=generator)

    m = m_channels
    w("head.conv1.weight", (m, 1, 3, 3))
    bn("head.bn1", m)
    for layer in ("layer1", "layer2"):
        for i in range(2):
            pre = f"head.{layer}.{i}"
            w(f"{pre}.conv1.weight", (m, m, 3, 3))
            bn(f"{pre}.bn1", m)
            w(f"{pre}.conv2.weight", (m, m, 3, 3))
            bn(f"{pre}.bn2", m)
            if i == 0:  # stride 2: a 1x1 shortcut
                w(f"{pre}.shortcut.0.weight", (m, m, 1, 1))
                bn(f"{pre}.shortcut.1", m)
    w("head.conv2.weight", (m, m, 3, 3))
    bn("head.bn2", m)
    ch = INIT_CHANNELS
    w("xvector.tdnn.linear.weight", (ch, m * (feat_dim // 8), 5))
    bn("xvector.tdnn.nonlinear.batchnorm", ch)
    bn_ch = BN_SIZE * GROWTH
    for bi, (n_layers, kernel, _) in enumerate(BLOCK_SPECS, start=1):
        for j in range(n_layers):
            pre = f"xvector.block{bi}.tdnnd{j + 1}"
            cin = ch + j * GROWTH
            bn(f"{pre}.nonlinear1.batchnorm", cin)
            w(f"{pre}.linear1.weight", (bn_ch, cin, 1))
            bn(f"{pre}.nonlinear2.batchnorm", bn_ch)
            w(f"{pre}.cam_layer.linear_local.weight",
              (GROWTH, bn_ch, kernel))
            w(f"{pre}.cam_layer.linear1.weight", (bn_ch // 2, bn_ch, 1))
            b(f"{pre}.cam_layer.linear1.bias", bn_ch // 2)
            w(f"{pre}.cam_layer.linear2.weight", (GROWTH, bn_ch // 2, 1))
            b(f"{pre}.cam_layer.linear2.bias", GROWTH)
        ch += n_layers * GROWTH
        bn(f"xvector.transit{bi}.nonlinear.batchnorm", ch)
        w(f"xvector.transit{bi}.linear.weight", (ch // 2, ch, 1))
        ch //= 2
    bn("xvector.out_nonlinear.batchnorm", ch)
    w("xvector.dense.linear.weight", (embed_dim, 2 * ch, 1))
    bn("xvector.dense.nonlinear.batchnorm", embed_dim, affine=False)
    return sd


# -- a minimal ONNX writer: ModelProto.graph(7).initializer(5) TensorProtos

_ONNX_TYPES = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
               np.dtype(np.float16): 10, np.dtype(np.int32): 6}


def _varint(v: int) -> bytes:
    out = b""
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out += bytes([byte | 0x80])
        else:
            return out + bytes([byte])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    head = _varint((num << 3) | wire)
    if wire == 2:
        return head + _varint(len(payload)) + payload
    return head + payload


def write_onnx(path: Path, tensors: dict) -> int:
    """Write ``tensors`` as the initializers of an otherwise empty ONNX
    model (TensorProto: dims (1), data_type (2), name (8), raw_data (9),
    little-endian); returns the bytes written."""
    msgs = []
    for name, t in tensors.items():
        a = (t.detach().cpu().numpy() if torch.is_tensor(t)
             else np.asarray(t))
        a = np.ascontiguousarray(a)
        body = b"".join(_field(1, 0, _varint(d)) for d in a.shape)
        body += _field(2, 0, _varint(_ONNX_TYPES[a.dtype]))
        body += _field(8, 2, name.encode())
        body += _field(9, 2, a.astype(a.dtype.newbyteorder("<")).tobytes())
        msgs.append(_field(5, 2, body))
    model = _field(1, 0, _varint(8)) + _field(7, 2, b"".join(msgs))
    Path(path).write_bytes(model)
    return len(model)


def write_cosyvoice2(snapshot: Path, lm: dict, text_embed: torch.Tensor,
                     flow: dict, hift: dict, s3v2: Optional[dict],
                     campplus: dict) -> dict:
    """The FunAudioLLM/CosyVoice2-0.5B layout the loaders read:
    ``model.safetensors`` (the LM), ``flow.pt``,
    ``hift.pt`` (``generator.`` names), ``campplus.onnx`` and
    ``speech_tokenizer_v2.onnx`` (unless ``s3v2`` is None); returns bytes
    per file."""
    from vox_serve_tpu_torch.weights import save_safetensors

    snapshot = Path(snapshot)
    sizes = {"model.safetensors": save_safetensors(
        export_cosy_lm(lm, text_embed), snapshot / "model.safetensors")}

    def save(name, sd):
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   snapshot / name)
        sizes[name] = os.path.getsize(snapshot / name)

    save("flow.pt", export_cosy_flow(flow))
    save("hift.pt", export_hift(hift))
    sizes["campplus.onnx"] = write_onnx(snapshot / "campplus.onnx", campplus)
    if s3v2 is not None:
        sizes["speech_tokenizer_v2.onnx"] = write_onnx(
            snapshot / "speech_tokenizer_v2.onnx", export_s3v2(s3v2))
    return sizes


def export_campplus(params: dict) -> dict:
    """Inverse of ``load_campplus_params``: ``campplus.onnx``'s names."""
    out: dict = {}

    def bn(name, p):
        out[name + ".running_mean"] = p["mean"]
        out[name + ".running_var"] = p["var"]
        if "scale" in p:
            out[name + ".weight"] = p["scale"]
            out[name + ".bias"] = p["bias"]

    h = params["head"]
    for n in ("conv1", "conv2"):
        _conv(out, f"head.{n}", h[n])
    bn("head.bn1", h["bn1"])
    bn("head.bn2", h["bn2"])
    for layer in ("layer1", "layer2"):
        for i, r in enumerate(h[layer]):
            pre = f"head.{layer}.{i}"
            _conv(out, f"{pre}.conv1", r["conv1"])
            bn(f"{pre}.bn1", r["bn1"])
            _conv(out, f"{pre}.conv2", r["conv2"])
            bn(f"{pre}.bn2", r["bn2"])
            if "sc_conv" in r:
                _conv(out, f"{pre}.shortcut.0", r["sc_conv"])
                bn(f"{pre}.shortcut.1", r["sc_bn"])
    xv = params["xvector"]
    _conv(out, "xvector.tdnn.linear", xv["tdnn_conv"])
    bn("xvector.tdnn.nonlinear.batchnorm", xv["tdnn_bn"])
    for bi, (blk, tr) in enumerate(zip(xv["blocks"], xv["transits"]),
                                   start=1):
        for j, lp in enumerate(blk):
            pre = f"xvector.block{bi}.tdnnd{j + 1}"
            bn(f"{pre}.nonlinear1.batchnorm", lp["nl1"])
            _conv(out, f"{pre}.linear1", lp["lin1"])
            bn(f"{pre}.nonlinear2.batchnorm", lp["nl2"])
            for k, n in (("local", "linear_local"), ("cam1", "linear1"),
                         ("cam2", "linear2")):
                _conv(out, f"{pre}.cam_layer.{n}", lp[k])
        bn(f"xvector.transit{bi}.nonlinear.batchnorm", tr["nl"])
        _conv(out, f"xvector.transit{bi}.linear", tr["lin"])
    bn("xvector.out_nonlinear.batchnorm", xv["out_bn"])
    _conv(out, "xvector.dense.linear", xv["dense_lin"])
    bn("xvector.dense.nonlinear.batchnorm", xv["dense_bn"])
    return out


# ---------------------------------------------------------------------------
# GLM-4-Voice: the ChatGLM LM, the decoder repo, the Whisper-VQ tokenizer
# ---------------------------------------------------------------------------


def export_glm(params: dict, prefix: str = "transformer.") -> dict:
    """Inverse of ``load_glm_backbone`` and ``GLMVoiceLM._load_lm``: the
    ChatGLM layout (``transformer.encoder.layers.{i}.*`` with the fused
    ``self_attention.query_key_value`` weight and bias in q, k, v row
    order and the fused ``mlp.dense_h_to_4h`` in gate, up order;
    ``final_layernorm``; ``transformer.embedding.word_embeddings`` and
    ``transformer.output_layer``)."""
    bb = params["backbone"]
    L = bb["layers"]["input_norm"].shape[0]
    a, m = bb["layers"]["attn"], bb["layers"]["mlp"]
    enc = prefix + "encoder."
    out: dict = {}
    for i in range(L):
        pre = f"{enc}layers.{i}."
        out[pre + "self_attention.query_key_value.weight"] = torch.cat(
            [_t(a[n]["w"][i]) for n in ("q", "k", "v")])
        out[pre + "self_attention.query_key_value.bias"] = torch.cat(
            [a[n]["b"][i] for n in ("q", "k", "v")])
        out[pre + "self_attention.dense.weight"] = _t(a["o"]["w"][i])
        out[pre + "mlp.dense_h_to_4h.weight"] = torch.cat(
            [_t(m["gate"]["w"][i]), _t(m["up"]["w"][i])])
        out[pre + "mlp.dense_4h_to_h.weight"] = _t(m["down"]["w"][i])
        out[pre + "input_layernorm.weight"] = bb["layers"]["input_norm"][i]
        out[pre + "post_attention_layernorm.weight"] = (
            bb["layers"]["post_norm"][i])
    out[enc + "final_layernorm.weight"] = bb["final_norm"]
    out[prefix + "embedding.word_embeddings.weight"] = params["embed"]
    out[prefix + "output_layer.weight"] = _t(params["head"])
    return out


def export_glm_flow(params: dict) -> dict:
    """Inverse of ``load_glm_flow_params``: ``flow.pt``'s names
    (``GLMFlowModel.state_dict()`` of zai-org/glm-4-voice-decoder)."""
    out: dict = {}

    def ln(name, p):
        out[name + ".weight"] = p["w"]
        out[name + ".bias"] = p["b"]

    def gn_block(pre, p):
        _conv(out, f"{pre}.block.0", p["conv"])
        out[f"{pre}.block.1.weight"] = p["gn_w"]
        out[f"{pre}.block.1.bias"] = p["gn_b"]

    def resnet(pre, p):
        _lin(out, f"{pre}.mlp.1", p["mlp"])
        gn_block(f"{pre}.block1", p["block1"])
        gn_block(f"{pre}.block2", p["block2"])
        _conv(out, f"{pre}.res_conv", p["res_conv"])

    def tblocks(pre, blocks):
        for j, p in enumerate(blocks):
            b = f"{pre}.{j}"
            ln(f"{b}.norm1", p["norm1"])
            for n in ("to_q", "to_k", "to_v"):
                _lin(out, f"{b}.attn1.{n}", p["attn1"][n])
            _lin(out, f"{b}.attn1.to_out.0", p["attn1"]["to_out"])
            ln(f"{b}.norm3", p["norm3"])
            _lin(out, f"{b}.ff.net.0.proj", p["ff"]["proj"])
            _lin(out, f"{b}.ff.net.2", p["ff"]["out"])

    out["input_embedding.weight"] = params["input_embedding"]
    _lin(out, "spk_embed_affine_layer", params["spk_embed_affine_layer"])
    enc = params["encoder"]
    _lin(out, "encoder.embed.out.0", enc["embed_out"])
    ln("encoder.embed.out.1", enc["embed_norm"])
    for i, p in enumerate(enc["encoders"]):
        pre = f"encoder.encoders.{i}"
        sa = p["self_attn"]
        for n in ("linear_q", "linear_k", "linear_v", "linear_out",
                  "linear_pos"):
            _lin(out, f"{pre}.self_attn.{n}", sa[n])
        out[f"{pre}.self_attn.pos_bias_u"] = sa["pos_bias_u"]
        out[f"{pre}.self_attn.pos_bias_v"] = sa["pos_bias_v"]
        _lin(out, f"{pre}.feed_forward.w_1", p["feed_forward"]["w_1"])
        _lin(out, f"{pre}.feed_forward.w_2", p["feed_forward"]["w_2"])
        ln(f"{pre}.norm_mha", p["norm_mha"])
        ln(f"{pre}.norm_ff", p["norm_ff"])
    ln("encoder.after_norm", enc["after_norm"])
    _lin(out, "encoder_proj", params["encoder_proj"])
    reg = params["length_regulator"]
    for i, c in enumerate(reg["convs"]):
        _conv(out, f"length_regulator.model.{3 * i}", c["conv"])
        out[f"length_regulator.model.{3 * i + 1}.weight"] = c["gn_w"]
        out[f"length_regulator.model.{3 * i + 1}.bias"] = c["gn_b"]
    _conv(out, f"length_regulator.model.{3 * len(reg['convs'])}",
          reg["out"])

    e, est = "decoder.estimator", params["estimator"]
    _lin(out, f"{e}.time_mlp.linear_1", est["time_mlp"]["linear_1"])
    _lin(out, f"{e}.time_mlp.linear_2", est["time_mlp"]["linear_2"])
    n = len(est["down"])
    for i, d in enumerate(est["down"]):
        resnet(f"{e}.down_blocks.{i}.0", d["resnet"])
        tblocks(f"{e}.down_blocks.{i}.1", d["blocks"])
        _conv(out, f"{e}.down_blocks.{i}.2" + (".conv" if i != n - 1
                                               else ""), d["downsample"])
    for i, mb in enumerate(est["mid"]):
        resnet(f"{e}.mid_blocks.{i}.0", mb["resnet"])
        tblocks(f"{e}.mid_blocks.{i}.1", mb["blocks"])
    for i, u in enumerate(est["up"]):
        resnet(f"{e}.up_blocks.{i}.0", u["resnet"])
        tblocks(f"{e}.up_blocks.{i}.1", u["blocks"])
        _conv(out, f"{e}.up_blocks.{i}.2" + ("" if i == n - 1 else ".conv"),
              u["upsample"])
    gn_block(f"{e}.final_block", est["final_block"])
    _conv(out, f"{e}.final_proj", est["final_proj"])
    return out


def export_glm_vq(params: dict) -> dict:
    """Inverse of ``load_glm_vq_params``: the Whisper-VQ encoder's names
    in zai-org/glm-4-voice-tokenizer (its linear weights are already
    ``(out, in)``)."""
    out = {"conv1.weight": params["conv1_w"], "conv1.bias": params["conv1_b"],
           "conv2.weight": params["conv2_w"], "conv2.bias": params["conv2_b"],
           "embed_positions.weight": params["pos"],
           "codebook.weight": params["codebook"]}
    for i, lp in enumerate(params["layers"]):
        pre = f"layers.{i}"
        for name, key in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                          ("self_attn.v_proj", "v"),
                          ("self_attn.out_proj", "o"), ("fc1", "fc1"),
                          ("fc2", "fc2")):
            _conv(out, f"{pre}.{name}", lp[key])
        for name, key in (("self_attn_layer_norm", "ln1"),
                          ("final_layer_norm", "ln2")):
            out[f"{pre}.{name}.weight"] = lp[key + "_w"]
            out[f"{pre}.{name}.bias"] = lp[key + "_b"]
    return out


def write_glm_decoder(snapshot: Path, flow: dict, hift: dict) -> dict:
    """zai-org/glm-4-voice-decoder's layout: ``flow.pt`` and ``hift.pt``
    (``generator.`` names), written with ``torch.save``; returns bytes per
    file."""
    sizes = {}
    for name, sd in (("flow.pt", export_glm_flow(flow)),
                     ("hift.pt", export_hift(hift))):
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   Path(snapshot) / name)
        sizes[name] = os.path.getsize(Path(snapshot) / name)
    return sizes


# ---------------------------------------------------------------------------
# Step-Audio-2-mini: the LM with its audio encoder and adaptor, token2wav
# ---------------------------------------------------------------------------


def export_step_encoder(enc: dict, enc_prefix: str = "encoder.",
                        ada_prefix: str = "adapter.") -> dict:
    """Inverse of ``load_step_encoder_params``: the Whisper-style audio
    encoder (``blocks.{i}.attn.query`` ... ``mlp_ln``; linear weights
    already ``(out, in)``) and the adaptor."""
    out = {enc_prefix + "conv1.weight": enc["conv1_w"],
           enc_prefix + "conv1.bias": enc["conv1_b"],
           enc_prefix + "conv2.weight": enc["conv2_w"],
           enc_prefix + "conv2.bias": enc["conv2_b"],
           enc_prefix + "positional_embedding.weight": enc["pos"]}
    for i, lp in enumerate(enc["layers"]):
        pre = f"{enc_prefix}blocks.{i}"
        for name, key in (("attn.query", "q"), ("attn.key", "k"),
                          ("attn.value", "v"), ("attn.out", "o"),
                          ("mlp.0", "fc1"), ("mlp.2", "fc2")):
            _conv(out, f"{pre}.{name}", lp[key])
        for name, key in (("attn_ln", "ln1"), ("mlp_ln", "ln2")):
            out[f"{pre}.{name}.weight"] = lp[key + "_w"]
            out[f"{pre}.{name}.bias"] = lp[key + "_b"]
    out[enc_prefix + "after_norm.weight"] = enc["norm_w"]
    out[enc_prefix + "after_norm.bias"] = enc["norm_b"]
    out[ada_prefix + "conv.weight"] = enc["ada_conv_w"]
    out[ada_prefix + "conv.bias"] = enc["ada_conv_b"]
    _conv(out, ada_prefix + "linear1", enc["ada_l1"])
    _conv(out, ada_prefix + "linear2", enc["ada_l2"])
    return out


def export_step(params: dict, enc: Optional[dict] = None,
                enc_dtype: Optional[torch.dtype] = None) -> dict:
    """Inverse of ``StepAudio2LM._load_lm``: the Qwen2.5 layers under
    ``model.*`` (q/k/v biases), ``model.embed_tokens.weight``,
    ``lm_head.weight`` and, where given, the audio encoder and adaptor
    (``encoder.*``, ``adapter.*``, cast to ``enc_dtype``)."""
    out = export_llama_backbone(params["backbone"], "model.")
    out["model.embed_tokens.weight"] = params["embed"]
    out["lm_head.weight"] = _t(params["head"])
    if enc is not None:
        out.update(_cast(export_step_encoder(enc), enc_dtype))
    return out


def export_step_flow(params: dict) -> dict:
    """Inverse of ``load_step_flow_params``: ``token2wav/flow.pt``'s names
    (the Cosy encoder section, the DiT under ``decoder.estimator.*``)."""
    out = export_cosy_encoder_section(params)
    e, est = "decoder.estimator", params["estimator"]
    for i, b in enumerate(est["blocks"]):
        pre = f"{e}.blocks.{i}"
        for n in ("to_q", "to_k", "to_v", "proj"):
            _lin(out, f"{pre}.attn.{n}", b["attn"][n])
        _ln(out, f"{pre}.attn.q_norm", b["attn"]["q_norm"])
        _ln(out, f"{pre}.attn.k_norm", b["attn"]["k_norm"])
        _lin(out, f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        _lin(out, f"{pre}.mlp.fc2", b["mlp"]["fc2"])
        _conv(out, f"{pre}.conv.block.1", b["conv"]["conv1"])
        _ln(out, f"{pre}.conv.block.3", b["conv"]["norm"])
        _conv(out, f"{pre}.conv.block.6", b["conv"]["conv2"])
        _lin(out, f"{pre}.adaLN_modulation.1", b["adaln"])
    _lin(out, f"{e}.t_embedder.mlp.0", est["t_mlp1"])
    _lin(out, f"{e}.t_embedder.mlp.2", est["t_mlp2"])
    _lin(out, f"{e}.in_proj", est["in_proj"])
    _lin(out, f"{e}.final_layer.adaLN_modulation.1", est["final_adaln"])
    _lin(out, f"{e}.final_layer.linear", est["final_linear"])
    return out


def write_step_token2wav(snapshot: Path, flow: dict, hift: dict) -> dict:
    """stepfun-ai/Step-Audio-2-mini's ``token2wav/flow.pt`` and
    ``token2wav/hift.pt`` (``generator.`` names), written with
    ``torch.save``; returns bytes per file."""
    d = Path(snapshot) / "token2wav"
    d.mkdir(parents=True, exist_ok=True)
    sizes = {}
    for name, sd in (("flow.pt", export_step_flow(flow)),
                     ("hift.pt", export_hift(hift))):
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   d / name)
        sizes["token2wav/" + name] = os.path.getsize(d / name)
    return sizes


# ---------------------------------------------------------------------------
# Chatterbox: T3 with its conditioning encoder, s3gen, conds.pt; Perth
# ---------------------------------------------------------------------------


def export_chatterbox_cond(p: dict, prefix: str = "cond_enc.") -> dict:
    """Inverse of ``load_chatterbox_cond_params``."""
    pre = prefix + "perceiver."
    out = {prefix + "spkr_enc.weight": p["spkr_w"],
           prefix + "spkr_enc.bias": p["spkr_b"],
           prefix + "emotion_adv_fc.weight": p["emotion_w"],
           pre + "pre_attention_query": p["query"],
           pre + "attn.norm.weight": p["norm_w"],
           pre + "attn.norm.bias": p["norm_b"]}
    for n in ("to_q", "to_k", "to_v", "proj_out"):
        out[f"{pre}attn.{n}.weight"] = p[n]["w"]
        out[f"{pre}attn.{n}.bias"] = p[n]["b"]
    return out


def export_chatterbox_t3(params: dict, cond_enc: Optional[dict]) -> dict:
    """Inverse of ``ChatterboxLM._load_t3``: ``t3_cfg.safetensors``'s names
    (the Llama layers under ``tfmr.``, the text and speech tables, the
    learned position tables under ``*_pos_emb.emb``, ``speech_head`` in
    the ``(out, in)`` layout, and ``cond_enc.*``)."""
    out = export_llama_backbone(params["backbone"], "tfmr.")
    out["text_emb.weight"] = params["text_embed"]
    out["speech_emb.weight"] = params["speech_embed"]
    out["text_pos_emb.emb.weight"] = params["text_pos"]
    out["speech_pos_emb.emb.weight"] = params["speech_pos"]
    out["speech_head.weight"] = _t(params["speech_head"])
    if cond_enc is not None:
        out.update(export_chatterbox_cond(cond_enc))
    return out


def export_chatterbox_s3gen(flow: dict, hift: dict, s3v2: Optional[dict],
                            campplus: dict) -> dict:
    """``s3gen.safetensors``'s names: the flow under ``flow.``, HiFT under
    ``mel2wav.`` (weight-norm pairs), S3 v2 under ``tokenizer.`` (unless
    ``s3v2`` is None) and CAMPPlus under ``speaker_encoder.``."""
    out = {"flow." + k: v for k, v in export_cosy_flow(flow).items()}
    out.update(export_hift(hift, prefix="mel2wav."))
    if s3v2 is not None:
        out.update({"tokenizer." + k: v
                    for k, v in export_s3v2(s3v2).items()})
    out.update({"speaker_encoder." + k: v
                for k, v in export_campplus(campplus).items()})
    return out


def chatterbox_conds(generator: torch.Generator, prompt_tokens: int = 150,
                     gen_tokens: int = 150, mel_dim: int = 80,
                     spk_dim: int = 192, speaker_dim: int = 256) -> dict:
    """A random ``conds.pt`` in the published layout: ``t3`` (the speaker
    embedding, the prompt's speech tokens, the exaggeration) and ``gen``
    (the decoder's prompt tokens, prompt mel rows at two per token and
    x-vector)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def tokens(n):
        return torch.randint(0, 6561, (1, n), generator=generator)

    return {
        "t3": {"speaker_emb": normal(1, speaker_dim), "clap_emb": None,
               "cond_prompt_speech_tokens": tokens(prompt_tokens),
               "cond_prompt_speech_emb": None,
               "emotion_adv": torch.full((1, 1, 1), 0.5)},
        "gen": {"prompt_token": tokens(gen_tokens),
                "prompt_token_len": torch.tensor([gen_tokens]),
                "prompt_feat": normal(1, 2 * gen_tokens, mel_dim),
                "prompt_feat_len": None,
                "embedding": normal(1, spk_dim)},
    }


def write_chatterbox(snapshot: Path, lm: dict, cond_enc: Optional[dict],
                     flow: dict, hift: dict, s3v2: Optional[dict],
                     campplus: dict, conds: dict) -> dict:
    """The ResembleAI/chatterbox layout the loaders read:
    ``t3_cfg.safetensors``, ``s3gen.safetensors`` and ``conds.pt``;
    returns bytes per file."""
    from vox_serve_tpu_torch.weights import save_safetensors

    snapshot = Path(snapshot)
    sizes = {
        "t3_cfg.safetensors": save_safetensors(
            export_chatterbox_t3(lm, cond_enc),
            snapshot / "t3_cfg.safetensors"),
        "s3gen.safetensors": save_safetensors(
            export_chatterbox_s3gen(flow, hift, s3v2, campplus),
            snapshot / "s3gen.safetensors")}
    torch.save(conds, snapshot / "conds.pt")
    sizes["conds.pt"] = os.path.getsize(snapshot / "conds.pt")
    return sizes


def export_perth(params: dict) -> dict:
    """Inverse of ``load_perth_params``: PerthNet's state dict names (the
    encoder and the three decoder branches, seven convs each)."""
    out: dict = {}
    stacks = [("encoder.layers", params["encoder"])] + [
        (f"decoder.{b}_layers", params[f"dec_{b}"])
        for b in ("slow", "normal", "fast")]
    for name, convs in stacks:
        for i, c in enumerate(convs):
            _conv(out, f"{name}.{i}.conv", c)
    return out


def write_perth(snapshot: Path, params: dict) -> int:
    """resemble-ai/perth's ``perth_net_250000.pth.tar`` (``{"model":
    state}``); returns bytes."""
    path = Path(snapshot) / "perth_net_250000.pth.tar"
    torch.save({"model": {k: v.detach().cpu().contiguous()
                          for k, v in export_perth(params).items()}}, path)
    return os.path.getsize(path)


# ---------------------------------------------------------------------------
# Zonos-v0.1: the transformer, DAC 44.1 kHz, the speaker net
# ---------------------------------------------------------------------------


def export_zonos_backbone(bb: dict, prefix: str = "backbone.") -> dict:
    """Inverse of ``load_zonos_backbone``: the fused ``mixer.in_proj``
    (q, k, v rows), ``mixer.out_proj``, ``mlp.fc1`` (up rows, then the
    gate's), ``mlp.fc2`` and the LayerNorms ``norm`` / ``norm2`` /
    ``norm_f`` with their biases."""
    lay = bb["layers"]
    attn, mlp = lay["attn"], lay["mlp"]
    out = {prefix + "norm_f.weight": bb["final_norm"],
           prefix + "norm_f.bias": bb["final_norm_b"]}
    for i in range(lay["input_norm"].shape[0]):
        p = f"{prefix}layers.{i}."
        out[p + "mixer.in_proj.weight"] = torch.cat(
            [_t(attn[n]["w"][i]) for n in "qkv"])
        out[p + "mixer.out_proj.weight"] = _t(attn["o"]["w"][i])
        out[p + "mlp.fc1.weight"] = torch.cat(
            [_t(mlp["up"]["w"][i]), _t(mlp["gate"]["w"][i])])
        out[p + "mlp.fc2.weight"] = _t(mlp["down"]["w"][i])
        for name, key in (("norm", "input_norm"), ("norm2", "post_norm")):
            out[p + name + ".weight"] = lay[key][i]
            out[p + name + ".bias"] = lay[key + "_b"][i]
    return out


def export_zonos_conditioner(params: dict) -> dict:
    """Inverse of ``load_conditioner_params``: ``prefix_conditioner.*`` in
    float32, from the (numpy) conditioner tree."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    out = {"prefix_conditioner.norm.weight": f32(params["norm"]["scale"]),
           "prefix_conditioner.norm.bias": f32(params["norm"]["bias"])}
    names = {"phoneme_embedder": "phoneme_embedder.weight",
             "weight": "weight", "int_embedder": "int_embedder.weight",
             "uncond_vector": "uncond_vector"}
    # a linear projection is ``project``, an MLP ``project.0`` / ``.2``
    proj = {"w": "weight", "b": "bias", "w1": "0.weight", "b1": "0.bias",
            "w2": "2.weight", "b2": "2.bias"}
    for i, p in enumerate(params["conditioners"]):
        pre = f"prefix_conditioner.conditioners.{i}."
        for k, v in p.items():
            if k == "project":
                for pk, pv in v.items():
                    out[pre + "project." + proj[pk]] = f32(pv)
            else:
                out[pre + names[k]] = f32(v)
    return out


def export_zonos(params: dict, cond_params: dict,
                 dtype: Optional[torch.dtype] = torch.bfloat16) -> dict:
    """Inverse of ``ZonosLM._load_checkpoint``: the backbone, the 9
    ``embeddings.{i}`` tables and ``heads.{i}`` (``(out, in)``) in
    ``dtype``, and ``prefix_conditioner.*`` in float32."""
    out = export_zonos_backbone(params["backbone"])
    for i in range(params["embeds"].shape[0]):
        out[f"embeddings.{i}.weight"] = params["embeds"][i]
        out[f"heads.{i}.weight"] = _t(params["heads"][i])
    out = _cast(out, dtype)
    out.update(export_zonos_conditioner(cond_params))
    return out


def write_zonos(snapshot: Path, params: dict, cond_params: dict,
                conditioners: list) -> int:
    """Zyphra/Zonos-v0.1-transformer's layout: ``model.safetensors`` (the
    LM in bf16, the conditioner in float32) and a ``config.json`` whose
    ``prefix_conditioner.conditioners`` lists ``conditioners``; returns
    bytes."""
    import json

    from vox_serve_tpu_torch.weights import save_safetensors

    snapshot = Path(snapshot)
    (snapshot / "config.json").write_text(json.dumps(
        {"prefix_conditioner": {"conditioners": conditioners}}))
    return save_safetensors(export_zonos(params, cond_params),
                            snapshot / "model.safetensors")


def export_dac(params: dict) -> dict:
    """Inverse of ``load_dac_params``: descript/dac_44khz's plain-conv
    names (the 9 quantizers' codebooks and ``out_proj``, the decoder's
    ``conv1``, blocks with ``snake1`` / ``conv_t1`` / three residual units,
    ``snake1`` and ``conv2``)."""
    out: dict = {}
    for i, q in enumerate(params["quantizers"]):
        out[f"quantizer.quantizers.{i}.codebook.weight"] = q["codebook"]
        _conv(out, f"quantizer.quantizers.{i}.out_proj", q["out_proj"])
    dec = params["decoder"]
    _conv(out, "decoder.conv1", dec["stem"])
    for i, b in enumerate(dec["blocks"]):
        pre = f"decoder.block.{i}"
        out[f"{pre}.snake1.alpha"] = b["alpha_in"]
        _conv(out, f"{pre}.conv_t1", b["up"])
        for j, r in enumerate(b["res"], start=1):
            rp = f"{pre}.res_unit{j}"
            out[f"{rp}.snake1.alpha"] = r["alpha1"]
            _conv(out, f"{rp}.conv1", r["conv1"])
            out[f"{rp}.snake2.alpha"] = r["alpha2"]
            _conv(out, f"{rp}.conv2", r["conv2"])
    out["decoder.snake1.alpha"] = dec["alpha_out"]
    _conv(out, "decoder.conv2", dec["head"])
    return out


def write_dac(snapshot: Path, params: dict) -> int:
    """descript/dac_44khz's ``model.safetensors`` (float32); returns
    bytes."""
    from vox_serve_tpu_torch.weights import save_safetensors

    return save_safetensors(export_dac(params),
                            Path(snapshot) / "model.safetensors")


def export_zonos_speaker(params: dict) -> tuple[dict, dict]:
    """Inverse of ``load_zonos_speaker_params``: the ResNet293 base state
    dict (``front.*`` with eval-mode batch norms, ``pooling.attention.*``,
    ``bottleneck``) and the LDA-128 one (``weight``, ``bias``)."""
    out: dict = {}

    def bn(name, p):
        out[name + ".weight"], out[name + ".bias"] = p["scale"], p["bias"]
        out[name + ".running_mean"] = p["mean"]
        out[name + ".running_var"] = p["var"]

    f = params["front"]
    _conv(out, "front.conv1", f["conv1"])
    bn("front.bn1", f["bn1"])
    for li in range(1, 5):
        for i, b in enumerate(f[f"layer{li}"]):
            pre = f"front.layer{li}.{i}"
            for n in ("1", "2"):
                _conv(out, f"{pre}.conv{n}", b["conv" + n])
                bn(f"{pre}.bn{n}", b["bn" + n])
            if "down_conv" in b:
                _conv(out, f"{pre}.downsample.0", b["down_conv"])
                bn(f"{pre}.downsample.1", b["down_bn"])
    a = params["asp"]
    _conv(out, "pooling.attention.0", a["att_conv1"])
    bn("pooling.attention.2", a["att_bn"])
    _conv(out, "pooling.attention.3", a["att_conv2"])
    _conv(out, "bottleneck", params["bottleneck"])
    lda = {"weight": params["lda"]["w"], "bias": params["lda"]["b"]}
    return out, lda


def write_zonos_speaker(snapshot: Path, params: dict) -> dict:
    """Zyphra/Zonos-v0.1-speaker-embedding: the two ``torch.save`` files;
    returns bytes per file."""
    from vox_serve_tpu_torch.models.zonos import SPEAKER_FILES

    sizes = {}
    for name, sd in zip(SPEAKER_FILES, export_zonos_speaker(params)):
        path = Path(snapshot) / name
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   path)
        sizes[name] = os.path.getsize(path)
    return sizes
