"""Port parity, Zonos-v0.1 (vox_serve_tpu_torch/models/zonos.py) against
the JAX package's ZonosLM, on the CPU in float32 at the JAX Zonos test's
small widths (a 2-layer LayerNorm backbone at 64 wide, 4 query heads over
4 KV heads at head dim 16; DAC at decoder dim 64 with rates 4/2), the
port's weights carried into the JAX model:

* the registry names and the published widths (on the meta device): the
  backbone, DAC 44.1 kHz, sampling, windows, 11,425 samples a window;
* the EOS bias (codebooks 1-8 only) and ``post_sample``'s delay mask at
  ``gen_idx`` 0, 1, 8 and 20 (and none) equal to JAX's;
* ``embed`` (9 tables summed, feature rows where masked) and ``logits``
  (float32) within 1e-5 of JAX's;
* ``detokenize`` (the delay reverted, DAC, the 44.1 -> 24 kHz resample)
  within 1e-4 of JAX's on a window holding masked ids, with its length;
* ``preprocess`` rows, tokens and masks equal to JAX's for a text prompt
  (the fixture's IPA) and an unreadable upload (the uncond row) within
  1e-6, and an upload through the same speaker net (reduced
  ``scale_blocks``) within 1e-5;
* the port's worker against the JAX worker over one greedy stream of 150
  tokens, single-step and fused k=4: tokens equal on all 9 codebooks (the
  masked ids of the first 8 steps included), then four windows (50 tokens
  at 0, 41 and 82, and the final 27-token partial window at 123): PCM
  lengths equal and the samples within 4 int16 steps. Both models take the
  same weights with head 0's EOS column lowered (the final norm holds one
  hidden unit at 1, whose EOS weight is -50) so that the greedy stream
  runs to its cap; with that weight at +50 the first output is EOS on
  codebook 0 and both streams stop with no audio;
* an HTTP round trip through the port's app with an uploaded WAV: the PCM
  follows the overlap rule (``output_audio_length`` per 41 tokens) and
  every prompt row is a feature row.
"""

import asyncio
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from chip_smoke import multipart, overlap_pcm_samples, synth_wav
from test_torch_checkpoints import hub  # noqa: F401
from test_torch_weights import assert_trees_equal
from test_torch_zonos_conditioning import assert_equal_trees
from test_torch_zonos_speaker import _small_params
from vox_serve_tpu.codecs.snac import SNACConfig as JSNACConfig
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import zonos as jz
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.snac import SNACConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models import zonos as tzonos
from vox_serve_tpu_torch.encoders.zonos_speaker import \
    init_zonos_speaker_params
from vox_serve_tpu_torch.models.zonos import (DAC_CONFIG, DAC_ID, EOS_TOKEN,
                                              MASKED_TOKEN, N_CB, SPEAKER_ID,
                                              ZonosLM)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=1025, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=4, head_dim=16, intermediate_size=128,
          use_layer_norm=True)
DAC = dict(sampling_rate=44100, decoder_dim=64, decoder_rates=(4, 2),
           latent_dim=32, codebook_size=1024, codebook_dim=8,
           vq_strides=(1,) * 9, noise=False, depthwise=False)
PCM_STEPS = 4   # int16 steps
UPLOAD_TOL = 1e-5  # prefix rows of an upload (host rows otherwise: 1e-6)
STEPS = 150     # generated tokens of the worker stream
INTERVAL, OVERLAP = 50, 9
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "zonos_phonemes.json")


def _tm(seed=3) -> ZonosLM:
    return ZonosLM(dtype=torch.float32, seed=seed,
                   debug_backbone=tbb.BackboneConfig(**BB,
                                                     dtype=torch.float32),
                   debug_codec=SNACConfig(**DAC))


def _np(tree):
    return tparams.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _jx(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


def _jm(tm: ZonosLM) -> jz.ZonosLM:
    """The JAX model at the same widths with the port's weights."""
    jm = jz.ZonosLM(dtype=jnp.float32,
                    debug_backbone=jbb.BackboneConfig(**BB,
                                                      dtype=jnp.float32),
                    debug_codec=JSNACConfig(**DAC))
    jm.params = _jx(tm.params)
    jm.codec_params = _jx(tm.codec_params)
    jm._cond_params = tm._cond_params
    return jm


@pytest.fixture(scope="module")
def pair():
    tm = _tm()
    # the speaker net at reduced widths in both (random init has none)
    tm._speaker_params = _small_params(seed=5)
    jm = _jm(tm)
    jm._speaker_params = _jx(tm._speaker_params)
    return jm, tm


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("ref") / "ref.wav"
    p.write_bytes(synth_wav(72000, seed=0))
    return str(p)


def test_registry_and_full_width_config():
    for name in ("zonos", "Zyphra/Zonos-v0.1-transformer"):
        assert get_model_class(name) is ZonosLM
    m = ZonosLM(device="meta")
    cfg = m.backbone_config
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.intermediate_size) == (2048, 26, 16, 16, 128, 8192)
    assert cfg.use_layer_norm and cfg.rms_eps == 1e-5
    assert cfg.rope_theta == 10000.0 and not cfg.llama31_rope_scaling
    assert m.params["embeds"].shape == (N_CB, 1026, 2048)
    assert m.params["heads"].shape == (N_CB, 2048, 1025)
    assert "final_norm_b" in m.params["backbone"]
    assert m.codec_config == DAC_CONFIG
    assert (DAC_CONFIG.decoder_dim, DAC_CONFIG.decoder_rates,
            DAC_CONFIG.hop_per_latent) == (1536, (8, 8, 4, 2), 512)
    jcfg = jz.DAC_CONFIG
    assert {k: getattr(jcfg, k) for k in DAC} == {
        k: getattr(DAC_CONFIG, k) for k in DAC}
    assert (m.n_codebooks, m.vocab_size, m.detokenize_interval,
            m.detokenize_overlap, m.max_tokens, m.output_audio_length,
            m.sample_rate) == (9, 1025, 50, 9, 2048, 11425, 24000)
    sc = m.default_sampling_config
    assert (sc.min_p, sc.repetition_penalty, sc.repetition_window,
            sc.max_tokens) == (0.1, 3.0, 2, 2048)
    assert m.needs_input_features and m.needs_input_masks
    assert m.supports_audio_input
    assert m.checkpoint_parts == {"backbone": False, "codec": False,
                                  "speaker_encoder": False}


def test_eos_bias_and_delay_mask_match_jax(pair):
    jm, tm = pair
    logits = np.random.default_rng(0).standard_normal(
        (2, N_CB, 1025)).astype(np.float32)
    got = tm.adjust_logits(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jm.adjust_logits(jnp.asarray(logits))))
    assert np.all(got[:, 0] == logits[:, 0])
    assert np.all(got[:, 1:, EOS_TOKEN] < -1e30)
    ids = np.random.default_rng(1).integers(0, 1025, (4, N_CB), np.int32)
    gen = np.asarray([0, 1, 8, 20], np.int32)
    got = tm.post_sample(tm.params, None, torch.from_numpy(ids), None,
                         gen_idx=torch.from_numpy(gen))["sampled"].numpy()
    ref = np.asarray(jm.post_sample(jm.params, None, jnp.asarray(ids), None,
                                    gen_idx=jnp.asarray(gen))["sampled"])
    np.testing.assert_array_equal(got, ref)
    for row, g in zip(got, gen):
        assert np.all(row[g + 1:] == MASKED_TOKEN)
    np.testing.assert_array_equal(got[3], ids[3])  # past the delay
    np.testing.assert_array_equal(
        tm.post_sample(tm.params, None, torch.from_numpy(ids), None)[
            "sampled"].numpy(), ids)


def test_embed_and_logits_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(2)
    ids = rng.integers(-3, 1030, (6, N_CB)).astype(np.int32)  # clipped
    feats = rng.standard_normal((6, 64)).astype(np.float32)
    masks = np.zeros((6, N_CB), bool)
    masks[[1, 4]] = True
    for f, m in ((None, None), (feats, masks)):
        got = tm.embed(tm.params, torch.from_numpy(ids),
                       None if f is None else torch.from_numpy(f),
                       None if m is None else torch.from_numpy(m))
        ref = jm.embed(jm.params, jnp.asarray(ids),
                       None if f is None else jnp.asarray(f),
                       None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[[1, 4]], feats[[1, 4]])
    h = rng.standard_normal((3, 64)).astype(np.float32)
    got = tm.logits(tm.params, torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (3, N_CB, 1025)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.logits(jm.params, jnp.asarray(h))),
        atol=1e-5)


def test_detokenize_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(3)
    window = rng.integers(0, 1024, (2, INTERVAL, N_CB)).astype(np.int32)
    for t in range(N_CB - 1):  # the delay's masked ids (clamped to 1023)
        window[:, t, t + 1:] = MASKED_TOKEN
    got, cache = tm.detokenize(tm.codec_params, torch.from_numpy(window),
                               None)
    ref, _ = jm.detokenize(jm.codec_params, jnp.asarray(window), None)
    assert cache is None
    assert got.shape == (2, 1, tm.output_audio_length) == ref.shape
    assert tm.output_audio_length == jm.output_audio_length == 179
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert np.abs(np.asarray(ref)).max() > 1e-3


ZONOS_ID = "Zyphra/Zonos-v0.1-transformer"


def test_snapshots_load_and_exporters_read_back_by_jax(hub, monkeypatch):
    """The three snapshots written by the exporters at the small widths
    (the LM in bf16 with its conditioner in float32 and ``config.json``,
    DAC's ``model.safetensors``, the speaker net's two ``.pt`` files with
    every block at narrow planes), resolved through the hub cache by both
    packages' loaders (called directly: both serve random weights below
    1024 wide): every tree leaf for leaf equal, and equal to the source.
    A snapshot whose ``in_proj`` does not split logs both row counts and
    falls back."""
    src = _tm(seed=6)
    spk = init_zonos_speaker_params(torch.Generator().manual_seed(7), "cpu",
                                    in_planes=4)
    conds = src._conditioners
    synth.write_zonos(synth.snapshot_dir(hub, ZONOS_ID), src.params,
                      src._cond_params, conds)
    synth.write_dac(synth.snapshot_dir(hub, DAC_ID), src.codec_params)
    synth.write_zonos_speaker(synth.snapshot_dir(hub, SPEAKER_ID), spk)

    tm = ZonosLM(ZONOS_ID, dtype=torch.bfloat16,
                 debug_backbone=tbb.BackboneConfig(**BB),
                 debug_codec=SNACConfig(**DAC))
    jm = jz.ZonosLM(ZONOS_ID, debug_backbone=jbb.BackboneConfig(**BB),
                    debug_codec=JSNACConfig(**DAC))
    got, ref = tm._load_checkpoint(), jm._load_checkpoint()
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    tparams.tree_map(lambda a, b: torch.equal(a, b.to(a.dtype))
                     or pytest.fail("LM leaf"), got, src.params)
    assert tm._conditioners == jm._conditioners == conds
    assert_equal_trees(tm._cond_params, jm._cond_params)
    assert_equal_trees(tm._cond_params, src._cond_params)
    dac = tm._load_dac()
    assert_trees_equal(dac, jax.tree.map(np.asarray,
                                         jm._load_dac_checkpoint()))
    assert_trees_equal(dac, _np(src.codec_params))
    sp = tm._load_speaker_encoder()
    assert_trees_equal(sp, jax.tree.map(np.asarray,
                                        jm._load_speaker_encoder()))
    assert_trees_equal(sp, _np(spk))

    bad = ZonosLM(ZONOS_ID, dtype=torch.bfloat16,
                  debug_backbone=tbb.BackboneConfig(**{**BB,
                                                       "num_kv_heads": 2}),
                  debug_codec=SNACConfig(**DAC))
    warned = []
    monkeypatch.setattr(tzonos.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    assert bad._load_checkpoint() is None
    assert "in_proj has 192 rows, expected" in warned[0]
    assert warned[0].endswith("= 128); random init")


def _same_preprocess(got, ref, tol=1e-6):
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    assert got.input_features.dtype == np.float32
    np.testing.assert_allclose(got.input_features, ref.input_features,
                               atol=tol, rtol=0)


def test_preprocess_matches_jax(pair, ref_wav, tmp_path, monkeypatch):
    monkeypatch.setenv("VOX_PHONEME_FIXTURE", FIXTURE)
    jm, tm = pair
    text = "Hello world."
    plain = tm.preprocess(prompt=text)
    _same_preprocess(plain, jm.preprocess(prompt=text))
    # the fixture's 14 IPA symbols between BOS and EOS, and six rows
    assert plain.input_tokens.shape == (16 + 6, N_CB)
    assert np.all(plain.input_tokens == MASKED_TOKEN)
    assert plain.input_masks.all()
    kw = dict(language="fr-fr", emotion=[1, 0, 0, 0, 0, 0, 0, 1],
              speaking_rate="12")
    _same_preprocess(tm.preprocess(prompt=text, **kw),
                     jm.preprocess(prompt=text, **kw))
    up = tm.preprocess(prompt=text, audio_path=ref_wav)
    # the speaker vector comes from float32 convs in two packages
    _same_preprocess(up, jm.preprocess(prompt=text, audio_path=ref_wav),
                     UPLOAD_TOL)
    assert not np.allclose(up.input_features[16], plain.input_features[16])
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF not a wav")
    fallback = tm.preprocess(prompt=text, audio_path=str(bad))
    _same_preprocess(fallback, jm.preprocess(prompt=text,
                                             audio_path=str(bad)))
    np.testing.assert_array_equal(fallback.input_features,
                                  plain.input_features)


def _drain(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return np.frombuffer(out, np.int16)


def _generate(w, r, fused):
    w.run_lm_prefill([r])
    while not r.done_lm_generation:
        if fused and w.can_decode_multi([r], 4):
            w.run_lm_decode_multi([r], 4)
        else:
            w.run_lm_decode([r])
        w.sync()


def _eos_weight(jm, tm, w):
    """Hold hidden unit 0 of the final norm at 1 and give head 0's EOS
    column weight ``w`` there, in both models (fresh tensors)."""
    bb = dict(tm.params["backbone"])
    bb["final_norm"] = bb["final_norm"].clone()
    bb["final_norm_b"] = bb["final_norm_b"].clone()
    bb["final_norm"][0], bb["final_norm_b"][0] = 0.0, 1.0
    heads = tm.params["heads"].clone()
    heads[0, 0, EOS_TOKEN] = w
    tm.params = {**tm.params, "backbone": bb, "heads": heads}
    jm.params = _jx(tm.params)


WCFG = dict(max_batch_size=2, num_pages=64, page_size=16,
            prefill_token_buckets=(64,), max_prefill_requests=2)


def _workers(jm, tm, fused):
    cfg = dict(WCFG)
    if fused:
        cfg.update(fused_decode_steps=fused, fused_decode_buckets=(2,))
    return (JWorker(jm, JWorkerConfig(warmup=False, **cfg)),
            ModelWorker(tm, WorkerConfig(**cfg)))


@pytest.mark.parametrize("fused", [0, 4])
def test_worker_windows_match_jax_worker(fused):
    tm = _tm(seed=4)
    jm = _jm(tm)
    _eos_weight(jm, tm, -50.0)
    prompt = "hello zonos"
    n_prompt = len(tm.preprocess(prompt=prompt).input_tokens)
    assert n_prompt == len(prompt) + 8
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + STEPS - 1)
    jw, tw = _workers(jm, tm, fused)
    jr = JRequest(request_id="j", prompt=prompt)
    tr = Request(request_id="t", prompt=prompt)
    _generate(jw, jr, fused)
    _generate(tw, tr, fused)
    if fused:
        assert tw.step_stats()["replays"].get("decode_multi", 0) > 0
    toks = np.stack(tr.lm_output_tokens)
    np.testing.assert_array_equal(toks, np.stack(jr.lm_output_tokens))
    assert toks.shape == (STEPS, N_CB) and tr.finish_reason == "length"
    # the delay: output g masks codebooks j > g, then every id is a code
    for g in range(N_CB):
        assert np.all(toks[g, g + 1:] == MASKED_TOKEN)
        assert np.all(toks[g, :g + 1] < EOS_TOKEN)
    assert np.all(toks[N_CB:] < EOS_TOKEN)
    assert len(np.unique(toks[N_CB:, 0])) > 10  # not a constant stream

    step = INTERVAL - OVERLAP
    chunk = tm.output_audio_length
    for start in (0, 41, 82, 123):
        outs = []
        for w, r in ((jw, jr), (tw, tr)):
            r.next_audio_decode_idx = [start]
            w.run_detokenize([r])
            w.flush_detokenize()
            outs.append(_drain(r))
        ja, ta = outs
        n_out = min(STEPS - start, step)
        expect = chunk if n_out >= step else int(chunk * (n_out - 0.5)
                                                 / step)
        assert ta.size == ja.size == expect, start
        err = np.abs(ta.astype(np.int32) - ja).max()
        assert err <= PCM_STEPS, (start, err)
        assert np.abs(ja).max() > 100, start  # not silence
    assert tr.done_all


def test_eos_on_codebook_0_ends_the_stream():
    tm = _tm(seed=4)
    jm = _jm(tm)
    _eos_weight(jm, tm, 50.0)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(greedy=True,
                                                      max_tokens=40)
    jw, tw = _workers(jm, tm, 0)
    jr = JRequest(request_id="j", prompt="stop")
    tr = Request(request_id="t", prompt="stop")
    for w, r in ((jw, jr), (tw, tr)):
        _generate(w, r, 0)
        assert r.finish_reason == "stop" and not r.lm_output_audio_tokens
    np.testing.assert_array_equal(np.stack(tr.lm_output_tokens),
                                  np.stack(jr.lm_output_tokens))
    assert tr.lm_output_tokens[0][0] == EOS_TOKEN


def test_http_round_trip_with_an_upload(pair, ref_wav, tmp_path):
    """POST /generate with text and an uploaded WAV to the port's app; the
    scheduler runs in this process over the app's ZMQ sockets."""
    from aiohttp.test_utils import TestClient, TestServer

    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    text = "hi there"
    n_prompt = len(tm.preprocess(prompt=text).input_tokens)
    tm.sampling_config = tm.sampling_config.replace(
        greedy=True, max_tokens=n_prompt + 100)
    suffix = f"_torch_zonos_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=200, page_size=16,
        prefill_token_buckets=(64,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="zonos", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(ref_wav, "rb") as f:
        body, ctype = multipart({"text": text, "language": "en-us"},
                                {"audio": ("ref.wav", f.read())})

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=ZonosLM.SAMPLE_RATE))) as client:
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
    assert done["prompt_tokens"] == done["feature_rows"] == n_prompt
    n = done["audio_tokens"]
    assert n > INTERVAL
    pcm = np.frombuffer(data[44:], np.int16)
    assert pcm.size == overlap_pcm_samples(n, INTERVAL, OVERLAP,
                                           tm.output_audio_length)
    assert tuple(done["detok_windows"][0]) == (0, INTERVAL)
