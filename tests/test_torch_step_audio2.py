"""Port parity, Step-Audio-2-mini (vox_serve_tpu_torch/models/
step_audio_2.py) against the JAX package's StepAudio2LM, on the CPU in
float32 at the JAX Step test's small widths (``_small_backbone(158720,
qkv_bias=True)``, ``SMALL_STEP_FLOW``, ``SMALL_HIFT`` of
``tests/test_remaining_models.py``): the backbone, the tables and the
debug audio encoder drawn by the JAX package's inits and carried into the
port through ``params.tree_to_torch``; the flow and HiFT drawn by the
port's init and carried into JAX (their eager JAX inits take ~35 s on the
CPU).

* the registry names and the published widths (on the meta device);
* the prompt ids and masks equal to JAX's in text and audio modes (an
  uploaded WAV through the debug encoder and adaptor: one ``<audio>``
  marker per adaptor row inside the human turn), the feature rows
  spliced over the markers within 1e-4 of JAX's (relative to the peak),
  and ``embed`` taking them exactly;
* the interleaved routing with Step's offset and stop ids;
* the port's worker against the JAX worker over a stream with an
  uploaded WAV: greedy tokens equal, then a 28-token window, a 53-token
  catch-up window and 28-token windows to the end (the last partial),
  JAX's start noise (``jax.random.key(0)`` per window length) in the
  port's noise buffers: PCM lengths equal and the samples within 4 int16
  steps (the flow's 1e-4 relative and the sine source's float32 cumsum
  drift), the HiFT cache primed;
* an HTTP round trip with an uploaded WAV (speech to speech): the prompt
  carries the upload's spliced rows (``feature_rows`` in the scheduler's
  completed entry) and the PCM follows the overlap rule at 24 kHz;
* the loader's fallback through ``_init_params``: an LM that maps loads
  the encoder and adaptor from the same state (equal to JAX's); an LM
  that does not map leaves the encoder at its random init, as JAX does.
"""

import asyncio
import io
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from chip_smoke import overlap_pcm_samples
from test_torch_weights import assert_trees_equal
from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFTCfg
from vox_serve_tpu.codecs.step_dit import StepFlowConfig as JFlowCfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import step_audio_2 as jstep_mod
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.codecs.step_dit import StepFlowConfig
from vox_serve_tpu_torch.encoders.whisper_exact import (
    StepEncConfig, init_step_encoder_params)
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.step_audio_2 import (
    AUDIO_MARKER, AUDIO_OFFSET, ENC_SEED, PROMPT_POST, PROMPT_PRE, STOP_IDS,
    StepAudio2LM, step_audio_rows)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=158720, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qkv_bias=True)
FLOW = dict(input_size=32, output_size=32, heads=4, linear_units=64,
            num_blocks=1, up_blocks=1, vocab_size=6656, spk_dim=8,
            mel_dim=16, dit_depth=1, dit_hidden=32, dit_heads=2,
            dit_head_dim=16, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=2,
            upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
            f0_cond_channels=16)
FEAT_TOL = 1e-4  # relative to the rows' peak
PCM_STEPS = 4    # int16 steps
STEPS = 120      # generated tokens of the worker stream
INTERVAL, OVERLAP = 28, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return tparams.tree_to_torch(_np(tree), "cpu")


def _write_wav(path, n_samples, sr=16000, seed=0):
    t = np.arange(n_samples) / sr
    x = np.sin(2 * np.pi * (140 + 20 * seed) * t) * np.hanning(n_samples)
    pcm = (x * 12000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


class _JStep(jstep_mod.StepAudio2LM):
    """The JAX model at the small widths without its constructor's codec
    init (JAX's eager ``init_step_flow`` and ``init_hift`` take ~35 s on
    the CPU): the LM and the audio encoder from the JAX package's own inits
    (the constructor's random branch and key 41), the flow and HiFT from
    the port's init carried over."""

    def __init__(self, seed=0):
        jstep_mod.BaseLM.__init__(self, "stepfun-ai/Step-Audio-2-mini",
                                  jnp.float32)
        self._cfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
        self._flow_cfg = JFlowCfg(**FLOW)
        self._hift_cfg = JHiFTCfg(**HIFT)
        self.text_tokenizer = JDevTokenizer(BB["vocab_size"])
        self.assets_available = False
        ks = jax.random.split(jax.random.key(61 + seed), 3)
        H = BB["hidden_size"]
        self.params = {
            "backbone": jbb.init_backbone_params(self._cfg, ks[0]),
            "embed": jax.random.normal(ks[1], (BB["vocab_size"], H)) * 0.02,
            "head": jax.random.normal(ks[2], (H, BB["vocab_size"])) * 0.02,
        }
        codec = StepAudio2LM(dtype=torch.float32, seed=seed,
                             debug_backbone=tbb.BackboneConfig(
                                 **{**BB, "vocab_size": 256},
                                 dtype=torch.float32),
                             debug_flow=StepFlowConfig(**FLOW),
                             debug_hift=HiFTConfig(**HIFT)).codec_params
        self.codec_params = jax.tree.map(
            jnp.asarray, tparams.tree_map(lambda t: t.numpy(), codec))
        self.sampling_config = self.default_sampling_config


def jax_model(seed=0) -> jstep_mod.StepAudio2LM:
    jm = _JStep(seed)
    # text ids (and the stop ids) far below the audio ids in the head, so
    # that a greedy stream of the random model is mostly audio
    jm.params["head"] = jm.params["head"].at[:, :AUDIO_OFFSET].multiply(0.25)
    return jm


def port_model(jm=None, seed=3) -> StepAudio2LM:
    """The port's model at the small widths; with ``jm``, the JAX model's
    weights carried over."""
    tm = StepAudio2LM(dtype=torch.float32, seed=seed,
                      debug_backbone=tbb.BackboneConfig(
                          **BB, dtype=torch.float32),
                      debug_flow=StepFlowConfig(**FLOW),
                      debug_hift=HiFTConfig(**HIFT))
    if jm is not None:
        tm.params = _to_torch(jm.params)
        tm.codec_params = _to_torch(jm.codec_params)
        tm.enc_params = _to_torch(jm._enc_params)
    return tm


@pytest.fixture(scope="module")
def pair():
    jm = jax_model()
    return jm, port_model(jm)


def test_registry_and_full_width_config():
    for name in ("step-audio-2", "step-audio-2-mini",
                 "stepfun-ai/Step-Audio-2-mini"):
        assert get_model_class(name) is StepAudio2LM
    with torch.device("meta"):
        meta = StepAudio2LM(device="meta")
    cfg = meta.backbone_config
    assert cfg == tbb.BackboneConfig(
        vocab_size=158720, hidden_size=3584, num_layers=28, num_heads=28,
        num_kv_heads=4, intermediate_size=18944, qkv_bias=True,
        rope_theta=1_000_000.0)
    assert cfg.resolved_head_dim == 128 and not cfg.rope_interleaved
    assert cfg.rms_eps == 1e-6
    assert cfg.num_heads // cfg.num_kv_heads == 7
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params))
    assert 7.5e9 < n < 7.8e9
    assert meta.flow_config == StepFlowConfig(vocab_size=6656)
    assert meta.hift_config == HiFTConfig()
    assert meta.enc_config == StepEncConfig()
    n_enc = sum(t.numel() for t in tparams.tree_leaves(meta.enc_params))
    assert 0.6e9 < n_enc < 0.7e9
    assert meta.output_audio_length == 24000
    assert (meta.detokenize_interval, meta.detokenize_overlap) == (28, 3)
    assert meta.sample_rate == 24000 and meta.max_tokens == 2048
    sc = meta.default_sampling_config
    assert (sc.top_p, sc.temperature, sc.repetition_penalty,
            sc.repetition_window) == (0.9, 0.7, 1.05, -1)
    assert meta.checkpoint_parts == {"backbone": False, "encoder": False,
                                     "flow": False, "hift": False}
    assert meta.supports_audio_input
    assert meta.needs_input_features and meta.needs_input_masks


def test_interleaved_audio_routing(pair):
    """test_step_audio2_through_worker's routing on both models: an audio
    id goes in, a text id stays out, a stop id ends generation without
    audio."""
    jm, tm = pair
    out = []
    for m, R in ((jm, JRequest), (tm, Request)):
        req = R(request_id="s", prompt="x")
        m.update_request_state(req, np.array([AUDIO_OFFSET + 3], np.int32))
        assert len(req.lm_output_audio_tokens) == 1
        m.update_request_state(req, np.array([AUDIO_OFFSET - 1], np.int32))
        assert len(req.lm_output_audio_tokens) == 1
        m.update_request_state(req, np.array([STOP_IDS[1]], np.int32))
        assert req.done_lm_generation and req.finish_reason == "stop"
        assert len(req.lm_output_audio_tokens) == 1
        out.append(len(req.lm_output_tokens))
    assert out == [3, 3]
    for sid in STOP_IDS:
        assert tm.is_stop(np.array([sid], np.int32))
        assert jm.is_stop(np.array([sid], np.int32))
    assert not tm.is_stop(np.array([AUDIO_MARKER], np.int32))


def test_prompt_rows_match_jax(pair, tmp_path):
    jm, tm = pair
    tok = JDevTokenizer(BB["vocab_size"])
    for prompt in ("hello step", ""):
        got, ref = tm.preprocess(prompt=prompt), jm.preprocess(prompt=prompt)
        np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
        np.testing.assert_array_equal(got.input_masks, ref.input_masks)
        assert not got.input_masks.any()
        assert not got.input_features.any()
        assert got.input_features.shape == (len(got.input_tokens), 64)
        assert len(got.input_tokens) == len(PROMPT_PRE + prompt
                                            + PROMPT_POST)
    wav = _write_wav(tmp_path / "q.wav", 24000)
    got = tm.preprocess(prompt="ignored", audio_path=wav)
    ref = jm.preprocess(prompt="ignored", audio_path=wav)
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    T_a = step_audio_rows(24000)
    assert T_a == 9  # 1.5 s: 152 mel frames -> 76 -> 38 -> 9 rows
    rows = np.nonzero(got.input_masks[:, 0])[0]
    pre = len(tok.encode(PROMPT_PRE + "<audio_start>"))
    np.testing.assert_array_equal(rows, np.arange(pre, pre + T_a))
    assert (got.input_tokens[rows, 0] == AUDIO_MARKER).all()
    assert len(got.input_tokens) == len(PROMPT_PRE + "<audio_start>"
                                        + "<audio_end>" + PROMPT_POST) + T_a
    feats, jfeats = got.input_features, np.asarray(ref.input_features)
    assert np.abs(feats - jfeats).max() <= FEAT_TOL * np.abs(jfeats).max()
    assert not feats[~got.input_masks[:, 0]].any()
    assert np.abs(feats[rows]).min(axis=1).max() > 0
    # embed takes the feature rows over the markers, the table elsewhere
    ids = torch.from_numpy(got.input_tokens)
    x = tm.embed(tm.params, ids, torch.from_numpy(feats),
                 torch.from_numpy(got.input_masks))
    jx = jm.embed(jm.params, jnp.asarray(got.input_tokens),
                  jnp.asarray(feats), jnp.asarray(got.input_masks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(x[rows].numpy(), feats[rows])
    table = tm.params["embed"][ids[:, 0].long()]
    keep = ~got.input_masks[:, 0]
    np.testing.assert_array_equal(x[keep].numpy(), table[keep].numpy())


def _drain(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return np.frombuffer(out, np.int16)


def _plan(n):
    """28 at 0; a 53-token catch-up window at 25 (two ready windows, k =
    2); then 28-token windows every 25 until one reaches the last token
    (the smoke's overlap rule)."""
    plan, s = [([0], INTERVAL), ([25, 50], 53)], 75
    while True:
        plan.append(([s], INTERVAL))
        if s + INTERVAL >= n:
            return plan
        s += INTERVAL - OVERLAP


def test_worker_windows_match_jax_worker(pair, tmp_path):
    jm, tm = pair
    wav = _write_wav(tmp_path / "w.wav", 24000, seed=2)
    n_prompt = len(tm.preprocess(audio_path=wav).input_tokens)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + STEPS - 1)
    # the JAX detokenizer's noise (jax.random.key(0) per window length) in
    # the port's noise buffers
    for W in (28, 53):
        T2 = 2 * (W - OVERLAP)
        tm._flow_noise[T2] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(0), (1, FLOW["mel_dim"], T2))))
    cfg = dict(max_batch_size=2, num_pages=64, page_size=16,
               prefill_token_buckets=(256,), max_prefill_requests=2)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    assert tw._detok_lengths() == [28, 103, 53]
    assert tw.first_chunk_frames == jw.first_chunk_frames == 0
    jr = JRequest(request_id="j", audio_path=wav)
    tr = Request(request_id="t", audio_path=wav)
    for w, r in ((jw, jr), (tw, tr)):
        w.run_lm_prefill([r])
        while not r.done_lm_generation:
            w.run_lm_decode([r])
    assert int(tr.input_masks.sum()) == step_audio_rows(24000)
    np.testing.assert_array_equal(np.stack(tr.lm_output_tokens),
                                  np.stack(jr.lm_output_tokens))
    n = len(tr.lm_output_audio_tokens)
    assert n == len(jr.lm_output_audio_tokens)
    assert 100 < n <= STEPS
    assert tr.finish_reason == "length"

    window = tm.output_audio_length
    total = 0
    for idx, L in _plan(n):
        outs = []
        for w, r in ((jw, jr), (tw, tr)):
            r.next_audio_decode_idx = list(idx)
            w.run_detokenize([r])
            w.flush_detokenize()
            outs.append(_drain(r))
        ja, ta = outs
        assert ta.size == ja.size, idx
        err = np.abs(ta.astype(np.int32) - ja).max()
        assert err <= PCM_STEPS, (idx, err)
        assert np.abs(ja).max() > 100, idx  # not silence
        total += ta.size
    assert total == overlap_pcm_samples(n, INTERVAL, OVERLAP, window)
    assert bool(tw.codec_cache["hift"]["primed"][tr.slot])
    assert tr.done_all


def test_http_round_trip_with_uploaded_speech(tmp_path):
    """POST /generate with an uploaded WAV and no text (speech to speech)
    through the port's app over an in-process scheduler: the prompt holds
    the upload's adaptor rows, which the completed entry counts as
    ``feature_rows``; the PCM is the overlap rule over the stream's audio
    tokens, at 24,000 Hz."""
    from aiohttp.test_utils import TestClient, TestServer

    from chip_smoke import multipart
    from vox_serve_tpu_torch.scheduler import load_scheduler
    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    tm = port_model(seed=5)
    tm.params["head"][:, :AUDIO_OFFSET] *= 0.25
    wav_path = _write_wav(tmp_path / "speech.wav", 16000, seed=1)
    T_a = step_audio_rows(16000)
    n_prompt = len(PROMPT_PRE + "<audio_start><audio_end>" + PROMPT_POST) \
        + T_a
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=n_prompt + 70)
    suffix = f"_torch_step_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=256, page_size=16,
        prefill_token_buckets=(256,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="step-audio-2", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(wav_path, "rb") as f:
        body, ctype = multipart({"text": ""},
                                {"audio": ("speech.wav", f.read())})

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=StepAudio2LM.SAMPLE_RATE))) as client:
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
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == 24000
    (done,) = sched.completed
    assert done["prompt_tokens"] == n_prompt
    assert done["feature_rows"] == T_a == 6
    n = done["audio_tokens"]
    assert n > 28
    pcm = np.frombuffer(data[44:], np.int16)
    assert pcm.size == overlap_pcm_samples(
        n, INTERVAL, OVERLAP, tm.output_audio_length) > tm.output_audio_length


def test_loader_fallback_matches_jax(pair, tmp_path, monkeypatch):
    """A local snapshot with the LM (``model.*``, ``lm_head``) and the
    audio encoder (``encoder.*``, ``adapter.*``) in one safetensors file,
    loaded through ``_init_params`` (the constructor's path) and JAX's
    ``_load_checkpoint``: the LM maps, so the encoder loads too, equal to
    JAX's and to what was written. With one LM tensor missing the LM does
    not map, and the encoder stays at its random init (``ENC_SEED``) in the
    port and unloaded in JAX, though its tensors are all there."""
    jm, _ = pair
    src = port_model(seed=7)
    enc = init_step_encoder_params(tbb.seeded_generator("cpu", 8),
                                   src.enc_config, "cpu")
    state = synth.export_step(src.params, enc)
    model_dir = tmp_path / "step"
    model_dir.mkdir()
    synth.write_shards(model_dir, state, 2)

    def load_both():
        tm = port_model(seed=3)
        tm.model_name = str(model_dir)
        tm._init_params(3, True)
        jm2 = jax_model()
        jm2.model_name = str(model_dir)
        return tm, jm2, jm2._load_checkpoint()

    tm, jm2, jlm = load_both()
    assert tm.checkpoint_parts == {"backbone": True, "encoder": True,
                                   "flow": False, "hift": False}
    assert_trees_equal(tm.params, _np(jlm))
    assert_trees_equal(tm.params, tparams.tree_map(lambda t: t.numpy(),
                                                   src.params))
    assert_trees_equal(tm.enc_params, _np(jm2._enc_loaded))
    assert_trees_equal(tm.enc_params, tparams.tree_map(lambda t: t.numpy(),
                                                       enc))

    # the LM no longer maps: no encoder either, in both packages
    del state["model.layers.1.mlp.down_proj.weight"]
    for f in model_dir.glob("*.safetensors"):
        f.unlink()
    synth.write_shards(model_dir, state, 2)
    tm, jm2, jlm = load_both()
    assert jlm is None and jm2._enc_loaded is None
    assert tm.checkpoint_parts == {"backbone": False, "encoder": False,
                                   "flow": False, "hift": False}
    assert_trees_equal(tm.enc_params, tparams.tree_map(
        lambda t: t.numpy(), init_step_encoder_params(
            tbb.seeded_generator("cpu", ENC_SEED), tm.enc_config, "cpu")))
    assert tm.params["embed"].shape == (BB["vocab_size"], 64)
