"""Synthetic checkpoints in the published layouts, for the port's loaders.

No published weights can be fetched where this repository is tested, so
the loaders are held to checkpoints made from the port's own parameter
trees (random weights from a seed, at any width): each ``export_*`` here is
the inverse of a mapper of ``vox_serve_tpu_torch`` (``weights.py``,
``codecs/``, ``encoders/ecapa.py``, ``watermark/silentcipher.py``) and
returns ``{published tensor name: tensor}`` (HF ``(out, in)`` linear
layouts, per-layer and per-codebook tensors unstacked). The tests check the
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
