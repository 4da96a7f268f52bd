"""Port parity, each family's checkpoint loading against the JAX package's,
on the CPU at small widths: the same on-disk synthetic checkpoint (the HF
layout of tests/test_checkpoint_roundtrip.py, whose helpers are copied
here, or the output of ``synthetic_checkpoints.py``'s exporters, the
inverse of the port's mappers) is read by both packages, and the loaded
trees are equal leaf for leaf (by key path, bits and dtype).

* CSM-1B: ``_load_checkpoint`` through the constructor (backbone, depth,
  tables, Mimi codec and encoder under ``codec_model.``), and the default
  two-speaker context built from the snapshot's prompt WAVs;
* Qwen3-TTS: ``_load_checkpoint`` with the Base variant's
  ``speaker_encoder.*``; ``_load_codec_params`` (the decoder and the
  32-quantizer ``encoder.*`` Mimi model); debug configurations never
  resolve a checkpoint, and a debug codec never takes a codec snapshot;
* Orpheus-3B: ``_load_params`` (own and tied head) and ``_load_snac``
  from safetensors and from ``pytorch_model.bin`` (weight-norm pairs);
* SilentCipher: ``load_silentcipher_params`` on ``torch.save`` state
  dicts, ``_try_load_real_silentcipher`` through the hub cache (the
  ``hparams.yaml`` reader with and without ``yaml``), ``init_watermarker``
  serving it;
* CosyVoice2 and GLM-4-Voice snapshots (their own docstrings below);
* Step-Audio-2-mini: the LM with its audio encoder and adaptor in one
  safetensors state (``export_step``), ``token2wav/flow.pt``
  (``export_step_flow``) and ``token2wav/hift.pt`` (``export_hift``).

Every exporter is checked too: the JAX package's loaders read its output
back to the tree it came from.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from test_torch_weights import assert_trees_equal
from vox_serve_tpu.codecs import mimi as jmimi
from vox_serve_tpu.codecs.qwen3_codec import Qwen3CodecConfig as JCodecCfg
from vox_serve_tpu.models import csm as jcsm_mod
from vox_serve_tpu.models import orpheus as jorph_mod
from vox_serve_tpu.models import qwen3_tts as jqwen3_mod
from vox_serve_tpu.models.backbone import BackboneConfig as JBB
from vox_serve_tpu.models.depth import DepthConfig as JDepth
from vox_serve_tpu.watermark import silentcipher as jsc
from vox_serve_tpu.watermark import spectral as jspectral
from vox_serve_tpu.weights import DevTokenizer
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import mimi as tmimi
from vox_serve_tpu_torch.codecs.qwen3_codec import (Qwen3CodecConfig,
                                                    init_qwen3_codec)
from vox_serve_tpu_torch.codecs.snac import SNACConfig, init_snac_decoder
from vox_serve_tpu_torch.encoders.ecapa import EcapaConfig, init_ecapa
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.csm import CSMLM
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.orpheus import OrpheusLM
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.watermark import silentcipher as tsc
from vox_serve_tpu_torch.watermark import spectral as tspectral

torch.set_num_threads(1)

rng = np.random.default_rng(42)


# -- helpers copied from tests/test_checkpoint_roundtrip.py -----------------

def _r(*shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _llama_state(prefix, L, H, heads, kvh, hd, ffn, qk_norm=False):
    """HF Llama/Qwen layout under ``prefix`` (what
    load_llama_family_backbone consumes)."""
    s = {}
    for i in range(L):
        p = f"{prefix}layers.{i}."
        s[p + "self_attn.q_proj.weight"] = _r(heads * hd, H)
        s[p + "self_attn.k_proj.weight"] = _r(kvh * hd, H)
        s[p + "self_attn.v_proj.weight"] = _r(kvh * hd, H)
        s[p + "self_attn.o_proj.weight"] = _r(H, heads * hd)
        s[p + "mlp.gate_proj.weight"] = _r(ffn, H)
        s[p + "mlp.up_proj.weight"] = _r(ffn, H)
        s[p + "mlp.down_proj.weight"] = _r(H, ffn)
        s[p + "input_layernorm.weight"] = _r(H)
        s[p + "post_attention_layernorm.weight"] = _r(H)
        if qk_norm:
            s[p + "self_attn.q_norm.weight"] = _r(hd)
            s[p + "self_attn.k_norm.weight"] = _r(hd)
    s[prefix + "norm.weight"] = _r(H)
    return s


def _write_sharded(tmp_path, state):
    """Write the state as TWO safetensors shards (exercises the parallel
    shard merge in load_safetensors_state)."""
    from safetensors.numpy import save_file

    keys = sorted(state)
    mid = len(keys) // 2
    save_file({k: state[k] for k in keys[:mid]},
              str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({k: state[k] for k in keys[mid:]},
              str(tmp_path / "model-00002-of-00002.safetensors"))
    return str(tmp_path)


# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_np(tree):
    return tparams.tree_map(lambda t: t.numpy(), tree)


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """A hub cache both packages resolve through (the port reads
    ``HF_HUB_CACHE``; JAX's ``snapshot_download`` reads the constant)."""
    import huggingface_hub.constants as hf_constants

    cache = tmp_path / "hub"
    cache.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hf_constants, "HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    return cache


def _dev_tokenizers(mp, *mods):
    for m in mods:
        mp.setattr(m, "load_text_tokenizer",
                   lambda name, vocab: (DevTokenizer(vocab), False))


def _write_wav(path, n, sr=24000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.sin(np.arange(n) * 0.05) * 9000
                       ).astype(np.int16).tobytes())


# -- CSM ----------------------------------------------------------------------

CSM_BB = dict(vocab_size=50, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=16, intermediate_size=128,
              rope_theta=5e5, llama31_rope_scaling=True)
CSM_DEPTH = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=8, intermediate_size=64, max_seq=33)
MIMI = dict(n_codebooks=32, codebook_size=2048, vq_dim=8, num_filters=8,
            upsample_ratios=(4, 3), hidden_size=16, intermediate_size=32,
            head_dim=8, num_heads=2, num_kv_heads=2, num_layers=2,
            sliding_window=6)


@pytest.mark.parametrize("with_codec", [False, True])
def test_csm_checkpoint_matches_jax(tmp_path, monkeypatch, with_codec):
    L, H, dL, dH = 2, 64, 2, 32
    state = _llama_state("backbone_model.", L, H, 4, 2, 16, 128)
    state.update(_llama_state("depth_decoder.model.", dL, dH, 4, 2, 8, 64))
    state["backbone_model.embed_tokens.embed_audio_tokens.weight"] = _r(96, H)
    state["embed_text_tokens.weight"] = _r(80, H)
    state["lm_head.weight"] = _r(50, H)
    state["depth_decoder.model.inputs_embeds_projector.weight"] = _r(dH, H)
    state["depth_decoder.model.embed_tokens.weight"] = _r(96, H)
    state["depth_decoder.codebooks_head.weight"] = _r(31, dH, 50)
    mcfg = tmimi.MimiConfig(**MIMI)
    if with_codec:
        g = torch.Generator().manual_seed(8)
        dec = tmimi.init_mimi(mcfg, g, "cpu")
        enc = tmimi.init_mimi_encoder(mcfg, g, "cpu")
        mimi_state = synth.export_mimi(dec, "codec_model.")
        mimi_state.update(synth.export_mimi_encoder(
            synth.share_mimi_codebooks(dec, enc), "codec_model."))
        state.update({k: v.numpy() for k, v in mimi_state.items()})
        (tmp_path / "prompts").mkdir()
        for name in ("conversational_a", "conversational_b"):
            _write_wav(tmp_path / "prompts" / f"{name}.wav", 5 * 24)
    model_dir = _write_sharded(tmp_path, state)

    _dev_tokenizers(monkeypatch, jcsm_mod)
    jm = jcsm_mod.CSMLM(
        model_name=model_dir, dtype=jnp.float32,
        debug_backbone=JBB(**CSM_BB, dtype=jnp.float32),
        debug_depth=JDepth(**CSM_DEPTH, dtype=jnp.float32),
        debug_codec=jmimi.MimiConfig(**MIMI))
    tm = CSMLM(model_name=model_dir, dtype=torch.float32, device="cpu",
               debug_backbone=BackboneConfig(**CSM_BB, dtype=torch.float32),
               debug_depth=DepthConfig(**CSM_DEPTH, dtype=torch.float32),
               debug_codec=mcfg)
    assert_trees_equal(tm.params, _np(jm.params))
    assert tm.checkpoint_parts == {"backbone": True, "codec": with_codec,
                                   "codec_encoder": with_codec}
    assert tm.codec_assets_available == jm.codec_assets_available
    if with_codec:
        assert_trees_equal(tm.codec_params, _np(jm.codec_params))
        assert_trees_equal(tm.encoder_params, _np(jm._encoder_params))
        assert_trees_equal(tm.codec_params, _torch_np(dec))
        # the default context from the prompt WAVs, as JAX builds it
        assert tm.default_context is not None
        np.testing.assert_array_equal(tm.default_context[0],
                                      jm._default_context[0])
        np.testing.assert_array_equal(tm.default_context[1],
                                      jm._default_context[1])
    else:
        assert tm.encoder_params is None and tm.default_context is None


# -- Qwen3-TTS ---------------------------------------------------------------

Q_BB = dict(vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, qk_norm=True,
            rope_theta=1e6)
Q_DEPTH = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
               head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True)
Q_CODEC = dict(codebook_dim=32, codebook_size=2048, latent_dim=48,
               decoder_dim=64, hidden_size=32, intermediate_size=64,
               head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
               num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
               upsampling_ratios=(2, 2), vq_dim=16)
#: the codec checkpoint's encoder at small widths, with the fixed counts
#: the Qwen3 model's encoder config reads (8 layers, 4 blocks, 32 books)
ENC_MIMI = dict(n_codebooks=32, codebook_size=64, vq_dim=8, num_filters=4,
                upsample_ratios=(2, 2, 2, 2), hidden_size=16,
                intermediate_size=32, head_dim=8, num_heads=2,
                num_kv_heads=2, num_layers=8, sliding_window=6)
SMALL_ECAPA = dict(mel_dim=128, enc_dim=64, channels=(32, 32, 32, 32, 96),
                   se_channels=8, attention_channels=8)


class _JQwen3(jqwen3_mod.Qwen3TTSLM):
    """The JAX model without its own init (its random init compiles ~90
    XLA programs on the CPU); the loaders are called directly."""

    def _init_params(self):
        self.params, self.codec_params = {}, {}


def _qwen3_pair(name, monkeypatch, dtype="float32"):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tm = Qwen3TTSLM(name, dtype=tdt, device="cpu", seed=4,
                    debug_backbone=BackboneConfig(**Q_BB, dtype=tdt),
                    debug_depth=DepthConfig(**Q_DEPTH, dtype=tdt),
                    debug_codec=Qwen3CodecConfig(**Q_CODEC))
    _dev_tokenizers(monkeypatch, jqwen3_mod)
    jm = _JQwen3(name, dtype=jdt, debug_backbone=JBB(**Q_BB, dtype=jdt),
                 debug_depth=JDepth(**Q_DEPTH, dtype=jdt),
                 debug_codec=JCodecCfg(**Q_CODEC))
    return tm, jm


@pytest.mark.parametrize("variant", ["Base", "VoiceDesign"])
def test_qwen3_talker_checkpoint_matches_jax(tmp_path, hub, monkeypatch,
                                             variant):
    name = f"Qwen/Qwen3-TTS-12Hz-1.7B-{variant}"
    tm, jm = _qwen3_pair(name, monkeypatch)
    # a debug configuration never resolves a checkpoint, even a cached one
    spk = (init_ecapa(EcapaConfig(**SMALL_ECAPA),
                      torch.Generator().manual_seed(3), "cpu")
           if variant == "Base" else None)
    state = synth.export_qwen3(tm.params, spk)
    synth.write_shards(synth.snapshot_dir(hub, name), state)
    tm2, _ = _qwen3_pair(name, monkeypatch)
    assert tm2.checkpoint_parts["talker"] is False
    assert tm2.assets_available is False

    loaded = tm2._load_checkpoint()
    ref = jm._load_checkpoint()
    assert loaded is not None and ref is not None
    assert_trees_equal(loaded, _np(ref))
    assert_trees_equal(loaded, _torch_np(tm.params))  # the exporter
    if variant == "Base":
        assert tm2._spk_enc_cfg == EcapaConfig(mel_dim=128, enc_dim=64)
        assert_trees_equal(tm2._spk_enc_params, _np(jm._spk_enc_params))
        assert_trees_equal(tm2._spk_enc_params, _torch_np(spk))
    else:
        assert tm2._spk_enc_params is None
        assert getattr(jm, "_spk_enc_params", None) is None


def test_qwen3_codec_checkpoint_matches_jax(tmp_path, monkeypatch):
    tm, jm = _qwen3_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base", monkeypatch)
    g = torch.Generator().manual_seed(9)
    codec = init_qwen3_codec(Qwen3CodecConfig(**Q_CODEC), g, "cpu")
    enc = tmimi.init_mimi_encoder(tmimi.MimiConfig(**ENC_MIMI), g, "cpu")
    state = synth.export_qwen3_codec(codec)
    state.update(synth.export_mimi_encoder(enc, "encoder."))
    synth.write_shards(tmp_path, state)
    for m in (tm, jm):
        m.CODEC_REPO = str(tmp_path)
    got = tm._load_codec_params()
    ref = jm._load_codec_params()
    assert_trees_equal(got, _np(ref))
    assert_trees_equal(got, _torch_np(codec))
    assert tm._enc_mimi_cfg == tmimi.MimiConfig(
        n_codebooks=32, codebook_size=2048, vq_dim=256)
    assert_trees_equal(tm._codec_encoder, _np(jm._codec_encoder))
    assert_trees_equal(tm._codec_encoder, _torch_np(enc))


def test_qwen3_debug_codec_never_takes_a_codec_snapshot(hub, monkeypatch):
    g = torch.Generator().manual_seed(1)
    codec = init_qwen3_codec(Qwen3CodecConfig(**Q_CODEC), g, "cpu")
    synth.write_shards(synth.snapshot_dir(hub, Qwen3TTSLM.CODEC_REPO),
                       synth.export_qwen3_codec(codec))
    tm, _ = _qwen3_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base", monkeypatch)
    assert tm.checkpoint_parts == {"talker": False, "codec": False,
                                   "codec_encoder": False,
                                   "speaker_encoder": False}


# -- Orpheus + SNAC ----------------------------------------------------------

O_BB = dict(vocab_size=300, hidden_size=48, num_layers=2, num_heads=6,
            num_kv_heads=2, head_dim=8, intermediate_size=64,
            rope_theta=5e5, llama31_rope_scaling=True)


@pytest.fixture(scope="module")
def snac_tree():
    return init_snac_decoder(SNACConfig(), torch.Generator().manual_seed(2),
                             "cpu")


@pytest.mark.parametrize("tied,snac_file", [(False, "safetensors"),
                                            (True, "bin")])
def test_orpheus_and_snac_checkpoints_match_jax(tmp_path, hub, monkeypatch,
                                                snac_tree, tied, snac_file):
    snac_dir = synth.snapshot_dir(hub, "hubertsiuzdak/snac_24khz")
    snac_state = synth.export_snac(snac_tree, SNACConfig())
    if snac_file == "bin":
        torch.save(snac_state, snac_dir / "pytorch_model.bin")
    else:
        synth.write_shards(snac_dir, snac_state, 1)
    src = OrpheusLM(dtype=torch.float32, device="cpu", seed=6,
                    debug_backbone=BackboneConfig(**O_BB,
                                                  dtype=torch.float32))
    state = synth.export_orpheus(src.params, tied=tied)
    model_dir = tmp_path / "orpheus"
    model_dir.mkdir()
    synth.write_shards(model_dir, state)

    _dev_tokenizers(monkeypatch, jorph_mod)
    jm = jorph_mod.OrpheusLM(str(model_dir), dtype=jnp.float32,
                             debug_backbone=JBB(**O_BB, dtype=jnp.float32))
    tm = OrpheusLM(str(model_dir), dtype=torch.float32, device="cpu",
                   debug_backbone=BackboneConfig(**O_BB,
                                                 dtype=torch.float32))
    assert tm.checkpoint_parts == {"backbone": True, "codec": True}
    assert_trees_equal(tm.params, _np(jm.params))
    want = dict(src.params)
    if tied:
        want["head"] = src.params["embed"].T.contiguous()
    assert_trees_equal(tm.params, _torch_np(want))
    assert_trees_equal(tm.codec_params, _np(jm.codec_params))
    assert_trees_equal(tm.codec_params, _torch_np(snac_tree))


# -- SilentCipher -------------------------------------------------------------

def _sc_snapshot(hub, band=512):
    cfg = tsc.SilentCipherConfig(message_band_size=band)
    params = tsc.init_silentcipher(cfg, torch.Generator().manual_seed(7),
                                   "cpu")
    snap = synth.snapshot_dir(hub, "sony/silentcipher")
    synth.write_silentcipher(snap, params, cfg)
    return cfg, params, snap / "44_1_khz" / "73999_iteration"


def test_silentcipher_checkpoint_matches_jax(hub):
    cfg, params, ckpt = _sc_snapshot(hub)
    got = tsc.load_silentcipher_params(str(ckpt), cfg, device="cpu")
    ref = jsc.load_silentcipher_params(str(ckpt), jsc.SilentCipherConfig(
        message_band_size=512))
    assert_trees_equal(got, _np(ref))
    assert_trees_equal(got, _torch_np(params))

    wcfg = tspectral.WatermarkConfig()
    real = tspectral._try_load_real_silentcipher(wcfg, "cpu")
    jreal = jspectral._try_load_real_silentcipher(jspectral.WatermarkConfig())
    assert real is not None and jreal is not None
    assert real["_sc_cfg"] == cfg
    assert (jreal["_sc_cfg"].message_band_size, jreal["_sc_cfg"].sr) == (
        512, 44100)
    assert_trees_equal({"sc": real["sc"], "sc_msg": real["sc_msg"]},
                       _np({"sc": jreal["sc"], "sc_msg": jreal["sc_msg"]}))
    served = tspectral.init_watermarker(wcfg, torch.Generator(), "cpu")
    assert tspectral.watermark_kind(served) == "silentcipher"


def test_hparams_reader_without_yaml_matches_yaml(hub, monkeypatch):
    import builtins

    import yaml

    _, _, ckpt = _sc_snapshot(hub)
    path = ckpt / "hparams.yaml"
    path.write_text(path.read_text() + "name: 'sc model'\nnested:\n"
                    "  inner: 3\nlist:\n  - 1\nempty: null\n")
    want = yaml.safe_load(path.read_text())
    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("yaml blocked")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    got = tspectral.read_hparams(path)
    monkeypatch.undo()
    flat = {k: v for k, v in want.items() if not isinstance(v, (dict, list))}
    assert {k: got[k] for k in flat} == flat
    assert got["SR"] == 44100 and got["frame_level_normalization"] is True


# -- CosyVoice2 ---------------------------------------------------------------


def test_cosyvoice2_snapshot_matches_jax(tmp_path, monkeypatch):
    """``write_cosyvoice2``'s snapshot at the small widths (the LM in
    ``model.safetensors`` with q/k/v biases, ``flow.pt``, ``hift.pt`` under
    ``generator.``, ``campplus.onnx``), read by both packages' constructors:
    every tree equal leaf for leaf to JAX's and to what was written, each
    part reported from the checkpoint (S3 v2, not written, from the dev
    config); then a corrupt ``hift.pt`` falls back to random init in both,
    and the port reports it."""
    from test_torch_cosyvoice2 import BB as C_BB
    from test_torch_cosyvoice2 import FLOW, HIFT, small_model
    from vox_serve_tpu.codecs.cosyvoice_flow import CosyFlowConfig as JFlow
    from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFT
    from vox_serve_tpu.models import cosyvoice2 as jcosy_mod
    from vox_serve_tpu_torch.codecs.cosyvoice_flow import CosyFlowConfig
    from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
    from vox_serve_tpu_torch.models.cosyvoice2 import CosyVoice2LM

    src = small_model(seed=9)
    camp = synth.campplus_state(torch.Generator().manual_seed(2),
                                embed_dim=FLOW["spk_dim"])
    model_dir = tmp_path / "cosy"
    model_dir.mkdir()
    sizes = synth.write_cosyvoice2(
        model_dir, src.params, src.text_embed, src.codec_params["flow"],
        src.codec_params["hift"], None, camp)
    assert set(sizes) == {"model.safetensors", "flow.pt", "hift.pt",
                          "campplus.onnx"}

    def load_both():
        _dev_tokenizers(monkeypatch, jcosy_mod)
        jm = jcosy_mod.CosyVoice2LM(
            str(model_dir), dtype=jnp.float32,
            debug_backbone=JBB(**C_BB, dtype=jnp.float32),
            debug_flow=JFlow(**FLOW), debug_hift=JHiFT(**HIFT))
        tm = CosyVoice2LM(str(model_dir), dtype=torch.float32, device="cpu",
                          debug_backbone=BackboneConfig(
                              **C_BB, dtype=torch.float32),
                          debug_flow=CosyFlowConfig(**FLOW),
                          debug_hift=HiFTConfig(**HIFT))
        return jm, tm

    jm, tm = load_both()
    assert tm.checkpoint_parts == {"backbone": True, "flow": True,
                                   "hift": True, "s3v2": False,
                                   "campplus": True}
    jparams = _np(jm.params)
    assert_trees_equal(tm.text_embed, jparams.pop("text_embed"))
    assert_trees_equal(tm.params, jparams)
    assert_trees_equal(tm.params, _torch_np(src.params))
    assert_trees_equal(tm.text_embed, src.text_embed.numpy())
    assert_trees_equal(tm.codec_params, _np(jm.codec_params))
    assert_trees_equal(tm.codec_params, _torch_np(src.codec_params))
    assert_trees_equal(tm.campplus, _np(jm._campplus))

    (model_dir / "hift.pt").write_bytes(b"corrupt")
    jm, tm = load_both()
    assert tm.checkpoint_parts["hift"] is False
    assert tm.checkpoint_parts["flow"] is True
    assert_trees_equal(tm.codec_params["flow"], _np(jm.codec_params["flow"]))
    assert (jax.tree.structure(jax.tree.map(lambda a: 0,
                                            jm.codec_params["hift"]))
            == jax.tree.structure(tparams.tree_map(
                lambda t: 0, tm.codec_params["hift"])))


# -- GLM-4-Voice ---------------------------------------------------------------


def test_glm_snapshots_match_jax(tmp_path, hub, monkeypatch):
    """The three GLM-4-Voice repos at the small widths of
    ``test_torch_glm_voice.py``, written by ``synthetic_checkpoints.py``
    into a hub cache both packages resolve through: the ChatGLM LM
    (``export_glm``: fused q/k/v and gate/up, two shards),
    zai-org/glm-4-voice-decoder (``flow.pt``, ``hift.pt`` under
    ``generator.``) and zai-org/glm-4-voice-tokenizer (the Whisper-VQ
    safetensors at its debug config). Each part the port's model loads is
    equal leaf for leaf to JAX's loader's tree and to what was written, and
    reported loaded; a corrupt ``flow.pt`` is reported not loaded."""
    import dataclasses

    from test_torch_glm_voice import BB as G_BB
    from test_torch_glm_voice import FLOW, HIFT, small_model
    from vox_serve_tpu.codecs.glm_flow import GLMFlowConfig as JFlow
    from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFT
    from vox_serve_tpu.encoders import whisper_exact as jw
    from vox_serve_tpu.models import glm_voice as jglm_mod
    from vox_serve_tpu.weights import load_safetensors_state as jload
    from vox_serve_tpu_torch.codecs.glm_flow import load_glm_flow_params
    from vox_serve_tpu_torch.codecs.hifigan import load_hift_params
    from vox_serve_tpu_torch.models.glm_voice import GLMVoiceLM
    from vox_serve_tpu_torch.weights import resolve_model_dir, save_safetensors

    src = small_model(seed=11)
    lm_id = "zai-org/glm-4-voice-9b"
    state = synth.export_glm(src.params)
    assert state["transformer.encoder.layers.0.self_attention."
                 "query_key_value.weight"].shape == (64 + 2 * 32, 64)
    assert state["transformer.encoder.layers.1.mlp.dense_h_to_4h.weight"
                 ].shape == (2 * 128, 64)
    synth.write_shards(synth.snapshot_dir(hub, lm_id), state, 2)
    synth.write_glm_decoder(synth.snapshot_dir(hub, GLMVoiceLM.DECODER_REPO),
                            src.codec_params["flow"], src.codec_params["hift"])
    tok = synth.snapshot_dir(hub, GLMVoiceLM.ENCODER_REPO)
    save_safetensors(synth.export_glm_vq(src.vq_params),
                     tok / "model.safetensors")

    _dev_tokenizers(monkeypatch, jglm_mod)
    jm = jglm_mod.GLMVoiceLM(lm_id, dtype=jnp.float32,
                             debug_backbone=JBB(**G_BB, dtype=jnp.float32),
                             debug_flow=JFlow(**FLOW),
                             debug_hift=JHiFT(**HIFT))
    tm = small_model(seed=12)
    tm.model_name = lm_id

    # the LM: fused q/k/v and gate/up split as JAX splits them
    lm = tm._load_lm()
    assert_trees_equal(lm, _np(jm._load_checkpoint()))
    assert_trees_equal(lm, _torch_np(src.params))

    # the decoder repo: flow.pt and hift.pt through torch.load
    dec = resolve_model_dir(GLMVoiceLM.DECODER_REPO)
    flow = tm._load_part("flow", dec, "flow.pt", lambda sd: (
        load_glm_flow_params(sd, tm.flow_config)))
    hift = tm._load_part("hift", dec, "hift.pt", lambda sd: load_hift_params(
        {k.replace("generator.", ""): v for k, v in sd.items()},
        tm.hift_config))
    assert tm.checkpoint_parts["flow"] and tm.checkpoint_parts["hift"]
    for name, got in (("flow", flow), ("hift", hift)):
        sd = {k: v.numpy() for k, v in torch.load(
            dec / f"{name}.pt", weights_only=True).items()}
        ref = jm._load_flow(sd) if name == "flow" else jm._load_hift(sd)
        assert_trees_equal(got, _np(ref))
        assert_trees_equal(got, _torch_np(src.codec_params[name]))

    # the tokenizer repo (its gate is a backbone of width 1024 or more)
    monkeypatch.setattr(tm, "_cfg",
                        dataclasses.replace(tm._cfg, hidden_size=1024))
    vq = tm._load_vq()
    assert tm.checkpoint_parts["vq_encoder"]
    jcfg = jw.GLMVQConfig(**dataclasses.asdict(tm.vq_config))
    assert_trees_equal(vq, _np(jw.load_glm_vq_params(jload(tok), jcfg)))
    assert_trees_equal(vq, _torch_np(src.vq_params))

    (dec / "flow.pt").write_bytes(b"corrupt")
    assert tm._load_part("flow", dec, "flow.pt", lambda sd: (
        load_glm_flow_params(sd, tm.flow_config))) is None
    assert tm.checkpoint_parts["flow"] is False


# -- Step-Audio-2-mini ---------------------------------------------------------


def test_step_snapshot_matches_jax(tmp_path, hub, monkeypatch):
    """stepfun-ai/Step-Audio-2-mini at the small widths of
    ``test_torch_step_audio2.py``, written by ``synthetic_checkpoints.py``
    into a hub cache both packages resolve through: the LM (``model.*``
    with q/k/v biases, ``lm_head``) with ``encoder.*`` and ``adapter.*``
    in two shards (the encoder in bf16, as published), and
    ``token2wav/flow.pt`` and ``token2wav/hift.pt`` (``generator.``
    names). Each part the port's model loads is equal leaf for leaf to the
    JAX loader's tree and to what was written (the encoder to its bf16
    values), and reported loaded; a corrupt ``flow.pt`` is reported not
    loaded."""
    from test_torch_step_audio2 import jax_model, port_model
    from vox_serve_tpu_torch.codecs.hifigan import load_hift_params
    from vox_serve_tpu_torch.codecs.step_dit import load_step_flow_params
    from vox_serve_tpu_torch.weights import resolve_model_dir

    src = port_model(seed=13)
    g = torch.Generator().manual_seed(14)
    for n in ("q", "k", "v"):
        b = src.params["backbone"]["layers"]["attn"][n]["b"]
        b.copy_(torch.randn(b.shape, generator=g))
    lm_id = "stepfun-ai/Step-Audio-2-mini"
    state = synth.export_step(src.params, src.enc_params, torch.bfloat16)
    assert state["encoder.blocks.0.attn.query.weight"].dtype == \
        torch.bfloat16
    assert "encoder.blocks.1.attn.key.bias" not in state
    assert state["model.layers.1.self_attn.k_proj.bias"].shape == (32,)
    snap = synth.snapshot_dir(hub, lm_id)
    synth.write_shards(snap, state, 2)
    sizes = synth.write_step_token2wav(snap, src.codec_params["flow"],
                                       src.codec_params["hift"])
    assert set(sizes) == {"token2wav/flow.pt", "token2wav/hift.pt"}

    jm = jax_model()
    jm.model_name = lm_id
    tm = port_model(seed=15)
    tm.model_name = lm_id
    model_dir = resolve_model_dir(lm_id)

    lm, enc = tm._load_lm(model_dir)
    jlm = jm._load_checkpoint()
    assert tm.parts["backbone"] and tm.parts["encoder"]
    assert_trees_equal(lm, _np(jlm))
    assert_trees_equal(lm, _torch_np(src.params))
    assert_trees_equal(enc, _np(jm._enc_loaded))
    assert_trees_equal(enc, _torch_np(tparams.tree_map(
        lambda t: t.to(torch.bfloat16).float(), src.enc_params)))

    flow = tm._load_part("flow", model_dir, "token2wav/flow.pt",
                         lambda sd: load_step_flow_params(sd, tm.flow_config))
    hift = tm._load_part("hift", model_dir, "token2wav/hift.pt",
                         lambda sd: load_hift_params(
                             {k.replace("generator.", ""): v
                              for k, v in sd.items()}, tm.hift_config))
    assert tm.checkpoint_parts["flow"] and tm.checkpoint_parts["hift"]
    for name, got in (("flow", flow), ("hift", hift)):
        sd = {k: v.numpy() for k, v in torch.load(
            model_dir / "token2wav" / f"{name}.pt",
            weights_only=True).items()}
        ref = jm._load_flow(sd) if name == "flow" else jm._load_hift(sd)
        assert_trees_equal(got, _np(ref))
        assert_trees_equal(got, _torch_np(src.codec_params[name]))

    (model_dir / "token2wav" / "flow.pt").write_bytes(b"corrupt")
    assert tm._load_part("flow", model_dir, "token2wav/flow.pt",
                         lambda sd: load_step_flow_params(
                             sd, tm.flow_config)) is None
    assert tm.checkpoint_parts["flow"] is False
