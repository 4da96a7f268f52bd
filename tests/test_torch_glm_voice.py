"""Port parity, GLM-4-Voice-9B (vox_serve_tpu_torch/models/glm_voice.py,
ops/rope.py's interleaved rope, models/sts_common.py) against the JAX
package's GLMVoiceLM, on the CPU in float32 at the JAX GLM test's small
widths (``_small_backbone(168960, qkv_bias=True, rope_dim=8)``,
``SMALL_GLM_FLOW``) with GLM's HiFT levels ((8, 8), (7, 11), 22,050 Hz),
the port's random weights in both packages.

* the interleaved partial rope at rope_dim 64 of 128 and 8 of 16: 1e-6;
* a 2-layer GLM-style backbone (interleaved partial rope, q/k/v biases,
  GLM's RMSNorm eps): a ragged prefill and three decode steps within 1e-4
  of JAX's output's peak;
* the registry names and the published widths (on the meta device), the
  interleaved routing of sampled ids, the prompt ids in text and audio
  modes (an uploaded WAV through the Whisper-VQ encoder at its debug
  config) equal to JAX's;
* the port's worker against the JAX worker over one stream: greedy tokens
  equal, then a 25-token window, a 50-token catch-up window and the rest,
  both packages' flows started from the same noise: PCM lengths equal and
  the samples within 4 int16 steps (the flow's 1e-4 and the sine source's
  float32 cumsum drift over 172-frame windows), the HiFT cache primed;
* an HTTP round trip with an uploaded WAV (speech to speech): the prompt
  carries the upload's speech tokens and the PCM follows the trim rule
  over the windows the scheduler reports.
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

from chip_smoke import glm_window_samples, window_pcm_samples
from test_torch_models import Plan, _i
from vox_serve_tpu.codecs.glm_flow import GLMFlowConfig as JFlowCfg
from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFTCfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import glm_voice as jglm_mod
from vox_serve_tpu.ops import rope as jrope
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.glm_flow import GLMFlowConfig
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.encoders.whisper_exact import GLMVQConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.glm_voice import (AUDIO_OFFSET, STOP_IDS,
                                                  GLMVoiceLM, glm_prompt_text)
from vox_serve_tpu_torch.ops import rope as trope
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=168960, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qkv_bias=True,
          rope_dim=8, rope_interleaved=True, rms_eps=1.5625e-07)
FLOW = dict(input_size=32, output_size=32, heads=4, linear_units=64,
            num_blocks=1, vocab_size=16384, spk_dim=8, mel_dim=16,
            est_channels=(16, 16), est_head_dim=8, est_heads=2,
            est_n_blocks=1, est_mid_blocks=1, n_timesteps=2,
            regulator_layers=1)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=2,
            sampling_rate=22050, upsample_rates=(8, 8),
            upsample_kernel_sizes=(16, 16),
            source_resblock_kernel_sizes=(7, 11), f0_cond_channels=16)
ROPE_TOL = 1e-6
BACKBONE_TOL = 1e-4  # relative to the output's peak
PCM_STEPS = 4        # int16 steps
STEPS = 110          # generated tokens of the worker stream


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def small_model(seed=3) -> GLMVoiceLM:
    m = GLMVoiceLM(dtype=torch.float32, seed=seed,
                   debug_backbone=tbb.BackboneConfig(**BB,
                                                     dtype=torch.float32),
                   debug_flow=GLMFlowConfig(**FLOW),
                   debug_hift=HiFTConfig(**HIFT))
    # text ids (and the stop ids) far below the audio ids in the head, so
    # that a greedy stream of the random model is mostly audio
    m.params["head"][:, :AUDIO_OFFSET] *= 0.25
    return m


class _JGLM(jglm_mod.GLMVoiceLM):
    """The JAX model with the port's weights (no JAX init)."""

    def __init__(self, tm: GLMVoiceLM):
        jglm_mod.BaseLM.__init__(self, tm.model_name, jnp.float32)
        self._cfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
        self._flow_cfg = JFlowCfg(**FLOW)
        self._hift_cfg = JHiFTCfg(**HIFT)
        self.text_tokenizer = JDevTokenizer(BB["vocab_size"])
        self.assets_available = False

        def to_jax(tree):
            return jax.tree.map(jnp.asarray,
                                tparams.tree_map(lambda t: t.numpy(), tree))

        self.params = to_jax(tm.params)
        self.codec_params = to_jax(tm.codec_params)
        self.__dict__["_enc_params"] = to_jax(tm.vq_params)
        self.sampling_config = self.default_sampling_config


@pytest.fixture(scope="module")
def pair():
    tm = small_model()
    return _JGLM(tm), tm


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


@pytest.mark.parametrize("D,rd", [(128, 64), (16, 8), (16, None)])
def test_interleaved_rope_matches_jax(D, rd):
    rng = np.random.default_rng(0)
    T, H, KH = 7, 4, 2
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    pos = rng.integers(0, 3000, T).astype(np.int32)
    jf = jrope.rope_frequencies(rd or D, theta=10000.0)
    tf = trope.rope_frequencies(rd or D, 10000.0)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jq, jk = jrope.apply_rope_interleaved(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(pos), jf, rope_dim=rd)
    tq, tk = trope.apply_rope_interleaved(torch.from_numpy(q),
                                          torch.from_numpy(k), _i(pos), tf,
                                          rope_dim=rd)
    for got, ref in ((tq, jq), (tk, jk)):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= ROPE_TOL
    if rd is not None:  # the dims beyond rope_dim pass through
        np.testing.assert_array_equal(tq[..., rd:].numpy(), q[..., rd:])
    # pairs (2i, 2i+1) rotate: a rotation keeps each pair's norm
    pair_norm = np.hypot(q[..., 0:(rd or D):2], q[..., 1:(rd or D):2])
    np.testing.assert_allclose(
        np.hypot(tq.numpy()[..., 0:(rd or D):2],
                 tq.numpy()[..., 1:(rd or D):2]), pair_norm, rtol=1e-5)


def test_glm_backbone_prefill_and_decode_match_jax():
    kw = dict(BB, vocab_size=512)
    jcfg = jbb.BackboneConfig(**kw, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**kw, dtype=torch.float32)
    tp = tbb.init_backbone_params(tcfg, tbb.seeded_generator("cpu", 5),
                                  "cpu", layerwise=True)
    g = torch.Generator().manual_seed(6)
    for lin in tp["layers"]["attn"].values():
        if "b" in lin:
            lin["b"].copy_(torch.randn(lin["b"].shape, generator=g) * 0.1)
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), tp))
    plan = Plan(lens=(11, 6))
    shape = (2, plan.P, plan.page, 2 * kw["num_kv_heads"], kw["head_dim"])
    jpool = jnp.zeros(shape, jnp.float32)
    tpool = torch.zeros(shape)
    rng = np.random.default_rng(5)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool, None)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tpool)
        assert _rel(th.numpy(), jh) <= BACKBONE_TOL
    assert _rel(tpool.numpy(), jpool) <= BACKBONE_TOL
    # the layerwise draw makes the JAX init's tree
    jinit = jbb.init_backbone_params(jcfg, jax.random.key(0))
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, jinit))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, tp)))


def test_registry_and_full_width_config():
    for name in ("glm", "glm-4-voice", "THUDM/glm-4-voice-9b",
                 "zai-org/glm-4-voice-9b"):
        assert get_model_class(name) is GLMVoiceLM
    with torch.device("meta"):
        meta = GLMVoiceLM(device="meta")
    cfg = meta.backbone_config
    assert cfg == tbb.BackboneConfig(
        vocab_size=168960, hidden_size=4096, num_layers=40, num_heads=32,
        num_kv_heads=2, head_dim=128, intermediate_size=13696,
        qkv_bias=True, rope_theta=10000.0, rope_dim=64,
        rope_interleaved=True, rms_eps=1.5625e-07)
    assert cfg.num_heads // cfg.num_kv_heads == 16
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params))
    assert 9.4e9 < n < 9.6e9
    assert meta.flow_config == GLMFlowConfig()
    assert meta.hift_config.total_upsample == 256
    assert meta.vq_config == GLMVQConfig()
    assert meta.output_audio_length == 44032 == glm_window_samples(25)
    assert (meta.detokenize_interval, meta.detokenize_overlap) == (25, 0)
    assert meta.sample_rate == 22050 and meta.max_tokens == 2048
    sc = meta.default_sampling_config
    assert (sc.top_p, sc.temperature) == (0.8, 0.8)
    assert meta.checkpoint_parts == {"backbone": False, "flow": False,
                                     "hift": False, "vq_encoder": False}
    assert meta.supports_audio_input


def test_interleaved_audio_routing(pair):
    """test_glm_interleaved_audio_filtering's sequence on both models: a
    text id is kept out of the audio tokens, an audio id goes in, a stop
    id ends generation without audio."""
    jm, tm = pair
    out = []
    for m, R in ((jm, JRequest), (tm, Request)):
        req = R(request_id="g", prompt="x")
        m.update_request_state(req, np.array([100], np.int32))
        assert len(req.lm_output_audio_tokens) == 0
        m.update_request_state(req, np.array([AUDIO_OFFSET + 5], np.int32))
        assert len(req.lm_output_audio_tokens) == 1
        m.update_request_state(req, np.array([STOP_IDS[0]], np.int32))
        assert req.done_lm_generation and req.finish_reason == "stop"
        assert len(req.lm_output_audio_tokens) == 1
        out.append(len(req.lm_output_tokens))
    assert out == [3, 3]
    for sid in STOP_IDS:
        assert tm.is_stop(np.array([sid], np.int32))
    assert not tm.is_stop(np.array([AUDIO_OFFSET], np.int32))


def test_prompt_ids_match_jax(pair, tmp_path):
    jm, tm = pair
    for prompt in ("hello glm", ""):
        got, ref = tm.preprocess(prompt=prompt), jm.preprocess(prompt=prompt)
        np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
        assert len(got.input_tokens) == len(glm_prompt_text(prompt))
    wav = _write_wav(tmp_path / "q.wav", 24000)
    got = tm.preprocess(prompt=None, audio_path=wav)
    ref = jm.preprocess(prompt=None, audio_path=wav)
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    toks = tm._encode_audio_tokens(wav)
    np.testing.assert_array_equal(toks, jm._encode_audio_tokens(wav))
    assert toks.shape == (19,)  # 1.5 s: 150 mel frames -> ceil(150 / 8)
    assert len(got.input_tokens) == len(glm_prompt_text(None, toks))
    assert got.input_features is None and got.decoder_cache_init is None


def _drain(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return np.frombuffer(out, np.int16)


def test_worker_windows_match_jax_worker(pair, monkeypatch):
    jm, tm = pair
    n_prompt = len(tm.preprocess(prompt="hello glm").input_tokens)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + STEPS - 1)
    # one noise per window length in both packages (JAX draws (B, mel, F)
    # from jax.random.key(0) per call; the port keeps one row per length)
    noise = {}
    for W in (25, 50):
        F = GLMFlowConfig(**FLOW).feat_len(W)
        noise[F] = np.random.default_rng(W).standard_normal(
            (1, FLOW["mel_dim"], F)).astype(np.float32)
        tm._flow_noise[F] = torch.from_numpy(noise[F])
    orig = jglm_mod.glm_flow_forward

    def jax_flow(params, cfg, tokens, spk, rng, noise_=None):
        B, T = tokens.shape
        n = noise[cfg.feat_len(T)]
        return orig(params, cfg, tokens, spk, rng,
                    noise=jnp.broadcast_to(jnp.asarray(n), (B,) + n.shape[1:]))

    monkeypatch.setattr(jglm_mod, "glm_flow_forward", jax_flow)
    cfg = dict(max_batch_size=2, num_pages=64, page_size=16,
               prefill_token_buckets=(512,), max_prefill_requests=2)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    assert tw._detok_lengths() == [25, 100, 50]
    jr = JRequest(request_id="j", prompt="hello glm")
    tr = Request(request_id="t", prompt="hello glm")
    for w, r in ((jw, jr), (tw, tr)):
        w.run_lm_prefill([r])
        while not r.done_lm_generation:
            w.run_lm_decode([r])
    np.testing.assert_array_equal(np.stack(tr.lm_output_tokens),
                                  np.stack(jr.lm_output_tokens))
    n = len(tr.lm_output_audio_tokens)
    assert n == len(jr.lm_output_audio_tokens)
    assert 75 < n <= STEPS
    assert tr.finish_reason == "length"

    # 25 at 0; a 50-token catch-up window at 25 (two ready windows, k=2);
    # then 25-token windows to the end, the last one partial or whole
    plan = [([0], 25), ([25, 50], 50)] + [([s], 25)
                                           for s in range(75, n, 25)]
    for idx, L in plan:
        outs = []
        for w, r in ((jw, jr), (tw, tr)):
            r.next_audio_decode_idx = list(idx)
            w.run_detokenize([r])
            w.flush_detokenize()
            outs.append(_drain(r))
        ja, ta = outs
        expect = window_pcm_samples(min(n, idx[0] + L) - idx[0], [(0, L)])
        assert ta.size == ja.size == expect, idx
        err = np.abs(ta.astype(np.int32) - ja).max()
        assert err <= PCM_STEPS, (idx, err)
        assert np.abs(ja).max() > 100, idx  # not silence
    assert tr.extras["detok_windows"] == [(i[0], L) for i, L in plan]
    assert bool(tw.codec_cache["hift"]["primed"][tr.slot])
    assert tr.done_all


def test_http_round_trip_with_uploaded_speech(pair, tmp_path):
    """POST /generate with an uploaded WAV and no text (speech to speech)
    through the port's app over an in-process scheduler: the prompt is the
    audio-mode template with the upload's speech tokens; the PCM is the
    trim rule over the windows the scheduler reports, at 22,050 Hz."""
    from aiohttp.test_utils import TestClient, TestServer

    from chip_smoke import multipart
    from vox_serve_tpu_torch.scheduler import load_scheduler
    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    wav_path = _write_wav(tmp_path / "speech.wav", 16000, seed=1)
    toks = tm._encode_audio_tokens(wav_path)
    n_prompt = len(glm_prompt_text(None, toks))
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=n_prompt + 60)
    suffix = f"_torch_glm_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=256, page_size=16,
        prefill_token_buckets=(512,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="glm", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=22050)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(wav_path, "rb") as f:
        body, ctype = multipart({"text": ""},
                                {"audio": ("speech.wav", f.read())})

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=GLMVoiceLM.SAMPLE_RATE))) as client:
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
        assert w.getframerate() == 22050
    (done,) = sched.completed
    assert done["prompt_tokens"] == n_prompt
    n = done["audio_tokens"]
    assert n > 25
    pcm = np.frombuffer(data[44:], np.int16)
    assert pcm.size == window_pcm_samples(n, done["detok_windows"]) > 44032
