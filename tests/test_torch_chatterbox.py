"""Port parity, Chatterbox (vox_serve_tpu_torch/models/chatterbox.py)
against the JAX package's ChatterboxLM, on the CPU in float32 at the JAX
Chatterbox test's small widths (a 2-layer T3 at 64 wide with 4 query heads
over 4 KV heads, the small CosyVoice flow and HiFT), with one synthetic
ResembleAI/chatterbox snapshot at those widths (``t3_cfg.safetensors`` with
``cond_enc.*`` at C = 64, ``s3gen.safetensors`` with the flow, HiFT and a
full-width CAMPPlus, ``conds.pt``) loaded by the port, and its weights in
both packages:

* the registry names and the published widths (on the meta device);
* the snapshot's parts loaded (S3 v2 from its dev config: the snapshot
  has no ``tokenizer.*``); the exporters read back by the JAX loaders
  (T3, ``cond_enc.*``, the flow, HiFT, CAMPPlus, a ``tokenizer.*``
  section, ``conds.pt``);
* the prompt rows, masks and cache rows equal to JAX's preprocess: the
  default voice from ``conds.pt`` (at its stored exaggeration and at
  another), a voice clone through the weight-exact encoder, a clone
  through the dev path (no ``cond_enc.*``), and the neutral fallback of
  an unreadable upload; text rows bit-equal, conditioning rows within
  1e-5 (float32 encoders in two packages), S3 v2 tokens exact;
* ``embed`` and ``embed_step`` at prefill (masks: no position added) and
  decode (``speech_pos[gen_idx + 1]``, clipped at 4095) equal to JAX's;
* the port's worker against the JAX worker over one stream, single-step
  and fused k=4: greedy tokens equal over 100 steps, then four windows (25
  tokens at 0, a 47-token catch-up window at 22, 25 at 66 and a final
  partial window at 88), with JAX's flow noise in the port's noise buffers
  and the same Perth weights in both (the exporter's checkpoint through
  ``VOX_SERVE_PERTH_CKPT``; the encoder's last conv scaled to 1% so the
  mark stays under the signal, as a trained mark does): PCM lengths equal
  and the samples within 4 int16 steps;
* an HTTP round trip through the port's app with an uploaded WAV: the PCM
  follows the overlap rule (21,120 samples per 22 tokens).
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from chip_smoke import multipart, overlap_pcm_samples, synth_wav
from test_torch_chatterbox_cond import flat
from vox_serve_tpu.codecs.cosyvoice_flow import CosyFlowConfig as JFlowCfg
from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFTCfg
from vox_serve_tpu.encoders import chatterbox_cond as jcond
from vox_serve_tpu.encoders.perceiver import PerceiverConfig as JPercCfg
from vox_serve_tpu.encoders.s3_exact import S3V2Config as JS3Cfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import chatterbox as jchat
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.weights import load_llama_family_backbone as jload
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.cosyvoice_flow import CosyFlowConfig
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.encoders.campplus import load_campplus_params
from vox_serve_tpu_torch.encoders.chatterbox_cond import (
    init_chatterbox_cond_params)
from vox_serve_tpu_torch.encoders.perceiver import PerceiverConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.chatterbox import (COND_LEN, START_SPEECH,
                                                   START_TEXT, STOP_SPEECH,
                                                   STOP_TEXT, ChatterboxLM)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.watermark import perth as tperth
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig
from vox_serve_tpu_torch.weights import load_safetensors_file

torch.set_num_threads(1)

BB = dict(vocab_size=6563, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=4, head_dim=16, intermediate_size=128,
          llama31_rope_scaling=True, rope_theta=500_000.0)
FLOW = dict(input_size=32, output_size=32, heads=4, linear_units=64,
            num_blocks=1, up_blocks=1, vocab_size=6561, spk_dim=192,
            mel_dim=16, est_channels=16, est_head_dim=8, est_heads=2,
            est_n_blocks=1, est_mid_blocks=1, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=4,
            upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
            f0_cond_channels=16)
PERC = dict(in_dim=64, hidden=64, heads=4, n_latents=32)
PCM_STEPS = 4   # int16 steps
STEPS = 100     # generated tokens of the worker stream
COND_TOL = 1e-5
INTERVAL, OVERLAP, CHUNK = 25, 3, 21120


def _tm(model_name, seed=3) -> ChatterboxLM:
    return ChatterboxLM(
        model_name, dtype=torch.float32, seed=seed,
        debug_backbone=tbb.BackboneConfig(**BB, dtype=torch.float32),
        debug_flow=CosyFlowConfig(**FLOW), debug_hift=HiFTConfig(**HIFT),
        debug_perceiver=PerceiverConfig(**PERC))


def _np(tree):
    return tparams.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _jx(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


class _JChat(jchat.ChatterboxLM):
    """The JAX model with the port's weights (no JAX init); the snapshot's
    ``conds.pt`` and CAMPPlus read by the JAX loaders themselves."""

    def __init__(self, tm: ChatterboxLM, model_dir: str):
        jchat.BaseLM.__init__(self, model_dir, jnp.float32)
        self._cfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
        self._flow_cfg = JFlowCfg(**FLOW)
        self._hift_cfg = JHiFTCfg(**HIFT)
        self._perc_cfg = JPercCfg(**PERC)
        self.text_tokenizer = JDevTokenizer(jchat.TEXT_VOCAB)
        self.assets_available = False
        self.params = _jx(tm.params)
        self.codec_params = _jx(tm.codec_params)
        self.cond_params = _jx(tm.cond_params)
        self._cond_loaded = (None if tm.cond_enc is None
                             else _jx(tm.cond_enc))
        s3p, s3c = tm.s3v2
        self.__dict__["_s3v2"] = (_jx(s3p), JS3Cfg(
            n_state=s3c.n_state, heads=s3c.heads, layers=s3c.layers))
        self._encode_cond = self._cond_fn
        self.sampling_config = self.default_sampling_config


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A small ResembleAI/chatterbox snapshot from a random source model,
    and the source's trees."""
    d = tmp_path_factory.mktemp("chatterbox")
    src = _tm("ResembleAI/chatterbox", seed=11)
    g = torch.Generator().manual_seed(12)
    cond = init_chatterbox_cond_params(g, "cpu", channels=64)
    camp = load_campplus_params(synth.campplus_state(g))
    conds = synth.chatterbox_conds(g, mel_dim=FLOW["mel_dim"],
                                   spk_dim=FLOW["spk_dim"])
    sizes = synth.write_chatterbox(
        d, src.params, cond, src.codec_params["flow"],
        src.codec_params["hift"], None, camp, conds)
    assert set(sizes) == {"t3_cfg.safetensors", "s3gen.safetensors",
                          "conds.pt"}
    return d, src, cond, camp, conds


@pytest.fixture(scope="module")
def pair(snapshot):
    d = snapshot[0]
    tm = _tm(str(d))
    return _JChat(tm, str(d)), tm


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("ref") / "ref.wav"
    p.write_bytes(synth_wav(72000, seed=0))
    return str(p)


def test_registry_and_full_width_config():
    for name in ("chatterbox", "ResembleAI/chatterbox"):
        assert get_model_class(name) is ChatterboxLM
    with torch.device("meta"):
        meta = ChatterboxLM(device="meta")
    assert meta.backbone_config == tbb.BackboneConfig(
        vocab_size=6563, hidden_size=1024, num_layers=30, num_heads=16,
        num_kv_heads=16, intermediate_size=4096, llama31_rope_scaling=True,
        rope_theta=500_000.0)
    assert meta.backbone_config.resolved_head_dim == 64
    assert meta.flow_config == CosyFlowConfig(vocab_size=6561)
    assert meta.hift_config == HiFTConfig()
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params["backbone"]))
    assert 5.0e8 < n < 5.1e8  # 30 Llama layers at 1024
    shapes = {k: tuple(meta.params[k].shape) for k in (
        "text_embed", "speech_embed", "text_pos", "speech_pos",
        "speech_head")}
    assert shapes == {"text_embed": (704, 1024),
                      "speech_embed": (6563, 1024),
                      "text_pos": (2048, 1024), "speech_pos": (4096, 1024),
                      "speech_head": (1024, 6563)}
    assert meta.output_audio_length == CHUNK
    assert (meta.detokenize_interval, meta.detokenize_overlap) == (
        INTERVAL, OVERLAP)
    assert meta.vocab_size == 6563 and meta.max_tokens == 1000
    sc = meta.default_sampling_config
    assert (sc.top_p, sc.temperature, sc.repetition_penalty,
            sc.repetition_window) == (0.95, 0.8, 1.2, -1)
    assert meta.needs_watermarking and meta.watermarker_type == "perth"
    assert not any(meta.checkpoint_parts.values())
    assert set(meta.checkpoint_parts) == {"backbone", "cond_enc", "flow",
                                          "hift", "s3v2", "campplus",
                                          "conds"}
    # the KV pool: 30 layers x (K, V) x 16 heads x 64 x bf16 per token
    cfg = meta.backbone_config
    assert cfg.num_layers * 2 * cfg.num_kv_heads * 64 * 2 == 122880


def test_snapshot_loads_and_exporters_read_back_by_jax(snapshot, pair):
    d, src, cond, camp, conds = snapshot
    _, tm = pair
    assert tm.checkpoint_parts == {
        "backbone": True, "cond_enc": True, "flow": True, "hift": True,
        "s3v2": False, "campplus": True, "conds": True}
    for got, want in ((tm.params, src.params), (tm.cond_enc, cond),
                      (tm.codec_params, src.codec_params),
                      (tm.campplus, camp)):
        fg, fw = flat(got), flat(want)
        assert set(fg) == set(fw)
        for k in fg:
            np.testing.assert_array_equal(fg[k], fw[k])
    # the JAX loaders on the same files
    t3 = {k: v.numpy() for k, v in load_safetensors_file(
        d / "t3_cfg.safetensors").items()}
    fj = flat(jload(t3, 2, prefix="tfmr.", dtype=jnp.float32))
    fp = flat(src.params["backbone"])
    assert set(fj) == set(fp)
    for k in fj:
        np.testing.assert_array_equal(fj[k], fp[k])
    np.testing.assert_array_equal(t3["speech_head.weight"].T,
                                  src.params["speech_head"].numpy())
    fj = flat(jcond.load_chatterbox_cond_params(t3))
    assert all(np.array_equal(v, flat(cond)[k]) for k, v in fj.items())
    s3gen = {k: v.numpy() for k, v in load_safetensors_file(
        d / "s3gen.safetensors").items()}
    from vox_serve_tpu.codecs.cosyvoice_flow import load_cosy_flow_params
    from vox_serve_tpu.codecs.hifigan import load_hift_params
    from vox_serve_tpu.encoders.campplus import \
        load_campplus_params as jcamp
    for jtree, ttree in (
            (load_cosy_flow_params(s3gen, JFlowCfg(**FLOW), prefix="flow."),
             src.codec_params["flow"]),
            (load_hift_params(s3gen, JHiFTCfg(**HIFT), prefix="mel2wav."),
             src.codec_params["hift"]),
            (jcamp(s3gen, prefix="speaker_encoder."), camp)):
        fj, ft = flat(jtree), flat(ttree)
        assert set(fj) == set(ft)
        for k in fj:
            np.testing.assert_allclose(fj[k], ft[k], rtol=1e-6, atol=1e-7)
    # the tokenizer.* section (absent from this snapshot: the dev config)
    from vox_serve_tpu.encoders.s3_exact import load_s3v2_params as js3
    s3p, s3c = tm.s3v2
    sd = {k: v.numpy() for k, v in synth.export_chatterbox_s3gen(
        src.codec_params["flow"], src.codec_params["hift"], s3p,
        camp).items()}
    fj = flat(js3(sd, JS3Cfg(n_state=s3c.n_state, heads=s3c.heads,
                             layers=s3c.layers), prefix="tokenizer."))
    ft = flat(s3p)
    assert set(fj) == set(ft)
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k])
    # conds.pt as the JAX loader reads it
    jm = pair[0]
    jc = jm._default_conds
    np.testing.assert_array_equal(
        jc["gen"]["prompt_token"], conds["gen"]["prompt_token"][:, :128])
    np.testing.assert_array_equal(
        tm.default_conds["gen"]["prompt_feat"], jc["gen"]["prompt_feat"])
    assert jc["gen"]["prompt_feat"].shape == (1, 256, FLOW["mel_dim"])


def _same_preprocess(got, ref, cond_tol=COND_TOL):
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    np.testing.assert_allclose(got.input_features[:COND_LEN],
                               ref.input_features[:COND_LEN],
                               atol=cond_tol)
    np.testing.assert_array_equal(got.input_features[COND_LEN:],
                                  ref.input_features[COND_LEN:])
    assert (got.decoder_cache_init is None) == (
        ref.decoder_cache_init is None)
    if got.decoder_cache_init is not None:
        fg, fr = flat(got.decoder_cache_init), flat(ref.decoder_cache_init)
        assert set(fg) == set(fr)
        for k in fg:
            np.testing.assert_allclose(fg[k], fr[k], atol=1e-5)


@pytest.mark.parametrize("prompt", ["hello chatterbox world", "",
                                    "why: not...  this"])
def test_default_voice_rows_match_jax(pair, prompt):
    jm, tm = pair
    for emo in (None, 0.9):
        got = tm.preprocess(prompt=prompt, exaggeration=emo)
        ref = jm.preprocess(prompt=prompt, exaggeration=emo)
        _same_preprocess(got, ref)
        ids = tm.text_ids(prompt)
        assert ids[0] == START_TEXT and ids[-1] == STOP_TEXT
        assert len(got.input_tokens) == COND_LEN + len(ids) + 1
        assert got.input_masks.all() and not got.input_tokens.any()
        assert np.abs(got.input_features[:COND_LEN]).sum() > 0
        dci = got.decoder_cache_init
        assert int(dci["tok_pos"]) == 128 and int(dci["prompt_len"]) == 256
    # the start row: speech_emb[6561] + speech_pos[0]
    np.testing.assert_array_equal(
        got.input_features[-1], (tm.params["speech_embed"][START_SPEECH]
                                 + tm.params["speech_pos"][0]).numpy())
    assert tm.is_stop(np.array([STOP_SPEECH])) and not tm.is_stop(
        np.array([START_SPEECH]))


def test_clone_rows_match_jax(pair, ref_wav):
    jm, tm = pair
    toks = tm._ref_speech_tokens(ref_wav)
    np.testing.assert_array_equal(toks, jm._ref_speech_tokens(ref_wav))
    assert len(toks) == 75  # 3 s at 25 Hz
    got = tm.preprocess(prompt="clone me", audio_path=ref_wav)
    ref = jm.preprocess(prompt="clone me", audio_path=ref_wav)
    _same_preprocess(got, ref)
    dci = got.decoder_cache_init
    assert int(dci["tok_pos"]) == 75 and int(dci["prompt_len"]) == 0
    assert np.abs(dci["spk"].numpy()).sum() > 0  # CAMPPlus's x-vector
    # the dev path: no cond_enc.* (the dev speaker encoder, the perceiver)
    saved = tm.cond_enc, jm._cond_loaded
    try:
        tm.cond_enc = jm._cond_loaded = None
        got = tm.preprocess(prompt="clone me", audio_path=ref_wav,
                            exaggeration=0.8)
        ref = jm.preprocess(prompt="clone me", audio_path=ref_wav,
                            exaggeration=0.8)
        _same_preprocess(got, ref, cond_tol=1e-4)
    finally:
        tm.cond_enc, jm._cond_loaded = saved


def test_unreadable_upload_falls_back_to_the_neutral_voice(pair, tmp_path):
    jm, tm = pair
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    got = tm.preprocess(prompt="hello", audio_path=str(bad))
    ref = jm.preprocess(prompt="hello", audio_path=str(bad))
    _same_preprocess(got, ref)
    assert not got.input_features[:COND_LEN].any()
    assert got.decoder_cache_init is None


def test_embed_step_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    ids = np.array([[0], [5], [6562], [7000]], np.int32)
    feats = rng.standard_normal((4, 64)).astype(np.float32)
    masks = np.array([[True], [False], [True], [False]])
    pos = np.arange(4, dtype=np.int32)
    for f, m, g in ((feats, masks, np.zeros(4, np.int32)),  # prefill
                    (None, None, np.array([0, 7, 4094, 5000], np.int32)),
                    (None, None, None)):
        args = [None if a is None else torch.from_numpy(a)
                for a in (ids, f, m, pos, g)]
        got = tm.embed_step(tm.params, *args)
        ref = jm.embed_step(jm.params, *[None if a is None else
                                         jnp.asarray(a) for a in
                                         (ids, f, m, pos, g)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # decode adds speech_pos[gen_idx + 1], clipped to the table
    got = tm.embed_step(tm.params, torch.from_numpy(ids), None, None,
                        torch.from_numpy(pos),
                        torch.tensor([0, 7, 4094, 5000], dtype=torch.int32))
    plain = tm.embed(tm.params, torch.from_numpy(ids), None, None)
    sp = tm.params["speech_pos"]
    np.testing.assert_array_equal(
        got.numpy(), (plain + sp[[1, 8, 4095, 4095]]).numpy())
    h = torch.from_numpy(feats)
    np.testing.assert_allclose(
        tm.logits(tm.params, h).numpy(),
        np.asarray(jm.logits(jm.params, jnp.asarray(feats))), atol=1e-5)


def _drain(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return np.frombuffer(out, np.int16)


@pytest.fixture()
def soft_perth(tmp_path, monkeypatch):
    """The exporter's Perth checkpoint (random weights, the encoder's last
    conv at 1%) through ``VOX_SERVE_PERTH_CKPT`` for both workers."""
    cfg = tperth.PerthConfig()
    p = tperth.init_perth_params(cfg, torch.Generator().manual_seed(9),
                                 "cpu")
    p["encoder"][-1]["w"] *= 0.01
    synth.write_perth(tmp_path, p)
    monkeypatch.setenv("VOX_SERVE_PERTH_CKPT",
                       str(tmp_path / "perth_net_250000.pth.tar"))


def _generate(w, r, fused):
    w.run_lm_prefill([r])
    while not r.done_lm_generation:
        if fused and w.can_decode_multi([r], 4):
            w.run_lm_decode_multi([r], 4)
        else:
            w.run_lm_decode([r])
        w.sync()


@pytest.mark.parametrize("fused", [0, 4])
def test_worker_windows_match_jax_worker(pair, soft_perth, fused):
    jm, tm = pair
    prompt = "hello chatterbox"
    n_prompt = len(tm.preprocess(prompt=prompt).input_tokens)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + STEPS - 1)
    # the JAX worker's noise (jax.random.key(0) per window length) in the
    # port's noise buffers
    for W in (25, 47):
        T2 = 2 * (tm.FLOW_CTX_TOKENS + W)
        tm._flow_noise[T2] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(0), (1, FLOW["mel_dim"], T2))))
    cfg = dict(max_batch_size=2, num_pages=64, page_size=16,
               prefill_token_buckets=(128,), max_prefill_requests=2)
    if fused:
        cfg.update(fused_decode_steps=fused, fused_decode_buckets=(2,))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    assert tw._detok_lengths() == [25, 91, 47]
    assert tw.watermark_cfg.style == "perth"
    for key in ("perth", "_perth_cfg"):
        assert key in tw.watermark_params and key in jw.watermark_params
    jr = JRequest(request_id="j", prompt=prompt)
    tr = Request(request_id="t", prompt=prompt)
    _generate(jw, jr, fused)
    _generate(tw, tr, fused)
    if fused:
        assert tw.step_stats()["replays"].get("decode_multi", 0) > 0
    np.testing.assert_array_equal(np.stack(tr.lm_output_tokens),
                                  np.stack(jr.lm_output_tokens))
    assert len(tr.lm_output_audio_tokens) == STEPS
    assert tr.finish_reason == "length"

    slot = tr.slot
    # 25 at 0; a 47-token catch-up window at 22 (two ready windows, k=2);
    # 25 at 66; the final partial window at 88 (12 tokens of 22)
    for idx, L, n_out in (([0], 25, 22), ([22, 44], 47, 44), ([66], 25, 22),
                          ([88], 25, 12)):
        outs = []
        for w, r in ((jw, jr), (tw, tr)):
            r.next_audio_decode_idx = list(idx)
            w.run_detokenize([r])
            w.flush_detokenize()
            outs.append(_drain(r))
        ja, ta = outs
        full = (L - OVERLAP) * 2 * 480
        expect = full if n_out >= 22 or L > 25 else int(
            full * (n_out - 0.5) / 22)
        assert ta.size == ja.size == expect, idx
        err = np.abs(ta.astype(np.int32) - ja).max()
        assert err <= PCM_STEPS, (idx, err)
        assert np.abs(ja).max() > 100, idx  # not silence
    assert int(tw.codec_cache["tok_pos"][slot]) == 128 + 110
    assert tr.done_all


def test_http_round_trip_with_an_upload(pair, ref_wav, tmp_path):
    """POST /generate with text and an uploaded WAV to the port's app; the
    scheduler runs in this process over the app's ZMQ sockets. The PCM is
    21,120 samples per 22 tokens, the last window trimmed."""
    from aiohttp.test_utils import TestClient, TestServer

    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    n_prompt = len(tm.preprocess(prompt="hi there").input_tokens)
    tm.sampling_config = tm.sampling_config.replace(
        greedy=True, max_tokens=n_prompt + 60)
    suffix = f"_torch_chat_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=200, page_size=16,
        prefill_token_buckets=(128,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="chatterbox", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(ref_wav, "rb") as f:
        body, ctype = multipart({"text": "hi there"},
                                {"audio": ("ref.wav", f.read())})

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=ChatterboxLM.SAMPLE_RATE))) as client:
            for _ in range(200):
                if (await client.get("/health")).status == 200:
                    break
                await asyncio.sleep(0.05)
            r = await client.post("/generate", data=body,
                                  headers={"Content-Type": ctype})
            assert r.status == 200
            return await r.read()

    try:
        data = asyncio.run(asyncio.wait_for(round_trip(), 120))
    finally:
        stop.set()
        th.join(timeout=30)
        server.cleanup()
        sched.request_socket.close()
        sched.result_socket.close()
    assert data[:4] == b"RIFF"
    assert int.from_bytes(data[24:28], "little") == 24000
    (done,) = sched.completed
    assert done["prompt_tokens"] == n_prompt
    n = done["audio_tokens"]
    assert n > INTERVAL
    pcm = np.frombuffer(data[44:], np.int16)
    assert pcm.size == overlap_pcm_samples(n, INTERVAL, OVERLAP, CHUNK)
