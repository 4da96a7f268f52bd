"""Port parity, CSM-1B (vox_serve_tpu_torch/models/csm.py) against the JAX
package's CSMLM, on the CPU at the small widths of the JAX CSM test
(``SMALL_BACKBONE`` 2 x 64 at a GQA group of 2 with Llama-3.1 rope,
``SMALL_DEPTH`` 2 x 32, ``SMALL_MIMI``), float32, the port's random weights
copied into the JAX model, inputs from numpy seeds.

* the ``[speaker]text`` rows and masks equal to JAX's; the audio-context
  rows through ``mimi_encode`` with converted encoder params and a WAV
  file (``load_audio_mono`` equal to JAX's); the default 2-speaker context
  from a snapshot's ``prompts/``;
* ``embed`` (prefill with masks, decode without) at 1e-6, ``is_stop`` on
  codebook 31, the greedy ``depth_step`` tokens equal;
* the port's worker and scheduler against the JAX worker and scheduler,
  greedy, over >= 2 detokenize windows and a final partial one: tokens
  equal, watermarked PCM within 1e-4 of max |ref| plus one int16 step, the
  watermark params converted from the JAX worker's; each stream's PCM
  length what the trim rule gives for its audio tokens;
* the first-chunk ramp and the bf16 codec on the port's worker (the PCM
  rule with ramp windows; the cast leaves only the codec's float32
  tensors);
* one HTTP round trip through the app over an in-process scheduler.
"""

import asyncio
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _audio, _drive
from vox_serve_tpu import utils as jutils
from vox_serve_tpu.codecs import mimi as jmimi
from vox_serve_tpu.models import csm as jcsm_mod
from vox_serve_tpu.models.backbone import BackboneConfig as JBackboneConfig
from vox_serve_tpu.models.depth import DepthConfig as JDepthConfig
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch import utils as tutils
from vox_serve_tpu_torch.codecs import mimi as tmimi
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.csm import STOP_TOKEN, CSMLM
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=2051, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128,
          rope_theta=5e5, llama31_rope_scaling=True)
DEPTH = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, intermediate_size=64, max_seq=33)
MIMI = dict(n_codebooks=32, codebook_size=2048, vq_dim=8, num_filters=8,
            upsample_ratios=(4, 3), hidden_size=16, intermediate_size=32,
            head_dim=8, num_heads=2, num_kv_heads=2, num_layers=2,
            sliding_window=6)
FS = 24  # samples per frame at MIMI's rates (4 x 3 x 2)
PROMPTS = ("hi there", "hello, friend!")
STEPS = 25  # generated tokens per stream: windows at 0 and 10, then 5


class _JCSM(jcsm_mod.CSMLM):
    """The JAX model with its weights supplied by the test."""

    def _init_params(self):
        self.params, self.codec_params, self._encoder_params = {}, {}, None


def _port_model(seed=3):
    return CSMLM(dtype=torch.float32, seed=seed,
                 debug_backbone=BackboneConfig(**BB, dtype=torch.float32),
                 debug_depth=DepthConfig(**DEPTH, dtype=torch.float32),
                 debug_codec=tmimi.MimiConfig(**MIMI))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(),
                                                      tree))


@pytest.fixture(scope="module")
def pair():
    """The small CSM in both packages with the port's random weights."""
    tm = _port_model()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcsm_mod, "load_text_tokenizer",
                   lambda name, vocab: (JDevTokenizer(vocab), False))
        jm = _JCSM(dtype=jnp.float32,
                   debug_backbone=JBackboneConfig(**BB, dtype=jnp.float32),
                   debug_depth=JDepthConfig(**DEPTH, dtype=jnp.float32),
                   debug_codec=jmimi.MimiConfig(**MIMI))
    jm.params, jm.codec_params = _to_jax(tm.params), _to_jax(tm.codec_params)
    return jm, tm


def _write_wav(path, n, sr=24000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        pcm = (np.sin(np.arange(n * channels) * 0.03) * 8000).astype(np.int16)
        w.writeframes(pcm.tobytes())


def pcm_samples(n_tokens: int, fs: int, ends: set) -> int:
    """The PCM the worker's trim rule gives for ``n_tokens`` audio tokens
    in contiguous windows of ``fs`` samples per frame: whole frames, less
    half a frame when the last window is partial (``_resolve_detok`` keeps
    int(samples * (valid - 0.5) / window)). ``ends``: the positions where a
    window ends."""
    return fs * n_tokens - (0 if n_tokens in ends else fs // 2)


def test_registry_and_full_width_config():
    assert get_model_class("csm") is CSMLM
    assert get_model_class("sesame/csm-1b") is CSMLM
    with torch.device("meta"):
        meta = CSMLM(device="meta")
    assert meta.backbone_config == BackboneConfig(
        vocab_size=2051, hidden_size=2048, num_layers=16, num_heads=32,
        num_kv_heads=8, head_dim=64, intermediate_size=8192,
        rope_theta=500000.0, llama31_rope_scaling=True)
    assert meta.depth_config == DepthConfig(
        hidden_size=1024, num_layers=4, num_heads=8, num_kv_heads=2,
        head_dim=128, intermediate_size=8192, max_seq=33,
        rope_theta=500000.0)
    assert meta.codec_config == tmimi.MimiConfig()
    assert tuple(meta.params["depth"]["heads"].shape) == (31, 1024, 2051)
    assert tuple(meta.params["depth"]["embeds"].shape) == (65632, 2048)
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params))
    assert 1.6e9 < n < 1.8e9  # Llama-3.2-1B + text/audio tables + depth
    assert meta.output_audio_length == 19200 and meta.SAMPLE_RATE == 24000
    assert (meta.detokenize_interval, meta.detokenize_overlap,
            meta.n_codebooks, meta.max_tokens) == (10, 0, 33, 1200)
    assert meta.needs_watermarking and meta.needs_input_masks
    assert meta.watermarker_type == "silentcipher"
    assert not meta.supports_chained_detok
    sc = meta.default_sampling_config
    assert (sc.top_k, sc.temperature, sc.max_tokens) == (50, 0.9, 1200)


@pytest.mark.parametrize("prompt,speaker", [("hi", 0), ("Hello world.", 1),
                                            ("", "3")])
def test_prompt_rows_and_masks_match_jax(pair, prompt, speaker):
    jm, tm = pair
    got = tm.preprocess(prompt=prompt, speaker=speaker)
    ref = jm.preprocess(prompt=prompt, speaker=speaker)
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    assert got.input_tokens.dtype == np.int32 and got.input_masks.dtype == bool
    assert got.input_masks[:, -1].all() and not got.input_masks[:, :-1].any()


@pytest.mark.parametrize("sr,channels", [(24000, 1), (16000, 2)])
def test_load_audio_mono_equals_jax(tmp_path, sr, channels):
    path = tmp_path / "a.wav"
    _write_wav(path, 777, sr, channels)
    got = tutils.load_audio_mono(str(path), target_sr=24000)
    ref = jutils.load_audio_mono(str(path), target_sr=24000)
    assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()
    x, rate = tutils.load_audio_mono(str(path), None, return_sr=True)
    assert rate == sr and len(x) == 777


def test_audio_context_rows_match_jax(pair, tmp_path):
    """With encoder params, a reference WAV becomes Mimi-code rows (audio
    channels on, text off) plus a zero EOS frame; the default 2-speaker
    context from a snapshot's prompt WAVs is prepended."""
    jm, tm = pair
    je = jax.jit(lambda k: jmimi.init_mimi_encoder(jm._mimi_cfg, k))(
        jax.random.key(3))
    tm.encoder_params = tparams.tree_to_torch(jax.tree.map(np.asarray, je),
                                              "cpu")
    jm._encoder_params = je
    try:
        ref_wav = tmp_path / "ref.wav"
        _write_wav(ref_wav, 3 * FS)
        got = tm.preprocess(prompt="hi", audio_path=str(ref_wav), speaker=1)
        ref = jm.preprocess(prompt="hi", audio_path=str(ref_wav), speaker=1)
        np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
        np.testing.assert_array_equal(got.input_masks, ref.input_masks)
        toks, masks = got.input_tokens, got.input_masks
        assert masks[-1, :-1].all() and not masks[-1, -1]
        assert not toks[-1].any()  # the EOS frame
        assert int(masks[:, -1].sum()) == len("[1]hi")

        (tmp_path / "prompts").mkdir()
        for name in ("conversational_a", "conversational_b"):
            _write_wav(tmp_path / "prompts" / f"{name}.wav", 2 * FS)
        tm.set_default_context(tmp_path)
        jm._set_default_context(tmp_path)
        ctx = tm.default_context
        np.testing.assert_array_equal(ctx[0], jm._default_context[0])
        np.testing.assert_array_equal(ctx[1], jm._default_context[1])
        po = tm.preprocess(prompt="hi")
        assert len(po.input_tokens) == len(ctx[0]) + len("[0]hi")
        np.testing.assert_array_equal(po.input_tokens[:len(ctx[0])], ctx[0])
    finally:
        tm.encoder_params = tm.default_context = None
        jm._encoder_params = jm._default_context = None


def test_embed_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(4)
    T = 9
    toks = np.concatenate([rng.integers(0, 2051, (T, 32)),
                           rng.integers(0, 128256, (T, 1))], 1
                          ).astype(np.int32)
    masks = rng.random((T, 33)) < 0.5
    for m in (masks, None):
        ref = jm.embed(jm.params, jnp.asarray(toks),
                       None, None if m is None else jnp.asarray(m))
        got = tm.embed(tm.params, torch.from_numpy(toks), None,
                       None if m is None else torch.from_numpy(m))
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


def test_is_stop_reads_codebook_31(pair):
    _, tm = pair
    row = np.ones(33, np.int32)
    assert not tm.is_stop(row)
    row[-2] = STOP_TOKEN
    assert tm.is_stop(row)
    row[-2], row[0], row[-1] = 5, STOP_TOKEN, STOP_TOKEN
    assert not tm.is_stop(row)


def test_greedy_depth_step_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((3, 64)).astype(np.float32)
    cb0 = np.asarray([0, 17, 2050], np.int32)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(greedy=True)
    ref, _ = jm.depth_step(jm.params, jnp.asarray(hidden), jnp.asarray(cb0),
                           jax.random.key(0))
    got, fb = tm.depth_step(tm.params, torch.from_numpy(hidden),
                            torch.from_numpy(cb0), None)
    assert fb is None and got.dtype == torch.int32
    assert tuple(got.shape) == (3, 33)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[:, -1].any() and (got[:, 0].numpy() == cb0).all()


def _serve_pair(jm, tm):
    n_max = {p: len(tm.preprocess(prompt=p).input_tokens) + STEPS - 1
             for p in PROMPTS}
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=max(n_max.values()))
    cfg = dict(max_batch_size=2, num_pages=256, page_size=16,
               prefill_token_buckets=(64,), max_prefill_requests=2)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    assert tw.watermark_cfg == tw.watermark_cfg.__class__(
        style="silentcipher", sample_rate=24000)
    tw.watermark_params = tparams.tree_to_torch(
        jax.tree.map(np.asarray, jw.watermark_params), "cpu")
    jreqs = [JRequest(request_id=f"j{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(PROMPTS)]
    treqs = [Request(request_id=f"t{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(PROMPTS)]
    jmsgs = _drive(JScheduler(model_worker=jw, max_batch_size=2,
                              connect=False), jreqs)
    tsched = load_scheduler("base", model_worker=tw, max_batch_size=2,
                            connect=False)
    tmsgs = _drive(tsched, treqs)
    return tw, jreqs, treqs, jmsgs, tmsgs, tsched


def test_worker_streams_match_jax_worker(pair):
    jm, tm = pair
    tw, jreqs, treqs, jmsgs, tmsgs, tsched = _serve_pair(jm, tm)
    for j, t in zip(jreqs, treqs):
        assert j.done_all and t.done_all
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
        n = len(t.lm_output_audio_tokens)
        assert n >= 2 * 10 + 1 and n % 10  # two windows and a partial one
        ja = np.frombuffer(_audio(jmsgs, j.request_id), np.int16)
        ta = np.frombuffer(_audio(tmsgs, t.request_id), np.int16)
        assert ta.size == ja.size == pcm_samples(n, FS, set())
        ref = ja.astype(np.int32)
        err = np.abs(ta.astype(np.int32) - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1, err
    assert {c["request_id"]: c["audio_tokens"] for c in tsched.completed} == {
        t.request_id: len(t.lm_output_audio_tokens) for t in treqs}
    # the Mimi cache lives in the worker's slot rows, the sentinel's too
    assert tuple(tw.codec_cache["attn_k"].shape) == (3, 2, 6, 2, 8)
    assert tw._detok_lengths() == [10, 40, 20]


def test_detokenize_rows_are_watermarked(pair):
    """``_detok_rows`` = the codec, then ``apply_watermark`` on float32
    audio, then int16 PCM; the slot cache advances."""
    from vox_serve_tpu_torch.watermark import apply_watermark

    _, tm = pair
    w = ModelWorker(tm, WorkerConfig(max_batch_size=2, num_pages=64,
                                     page_size=16,
                                     prefill_token_buckets=(64,)))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, 2051, (2, 10, 33)
                                         ).astype(np.int32))
    slots = torch.tensor([1, 2])
    rows = tparams.tree_map(lambda a: a[slots].clone(), w.codec_cache)
    audio, _ = tm.detokenize(tm.codec_params, toks, rows)
    want = apply_watermark(w.watermark_params, w.watermark_cfg, audio[:, 0])
    pcm = w._detok_rows(toks, slots)
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (2, 1, 10 * FS)
    torch.testing.assert_close(
        pcm[:, 0], (torch.clamp(want, -1, 1) * 32767.0).to(torch.int16),
        rtol=0, atol=0)
    assert not torch.equal(want, audio[:, 0])
    np.testing.assert_array_equal(w.codec_cache["pos"].numpy(), [0, 20, 20])


def test_first_chunk_ramp_and_bf16_codec(pair):
    """``--first-chunk-frames 3`` with the bf16 codec on the online
    scheduler: mini windows of 3 and 6 frames run; the cast touches only
    the codec's float32 tensors (the Mimi ring's positions stay int32, the
    watermark float32); each stream's PCM follows the trim rule."""
    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=40)
    codec, make_cache = tm.codec_params, tm.init_decoder_cache
    try:
        w = ModelWorker(tm, WorkerConfig(
            max_batch_size=2, num_pages=256, page_size=16,
            prefill_token_buckets=(64,), max_prefill_requests=2,
            first_chunk_frames=3, codec_dtype="bfloat16"))
        assert w.codec_dtypes() == ["bfloat16"]
        assert w.codec_cache["pos"].dtype == torch.int32
        assert w.watermark_params["conv1"].dtype == torch.float32
        assert not w._chains_enabled()  # CSM rows do not chain (JAX's flag)
        s = load_scheduler("online", model_worker=w, max_batch_size=2,
                           connect=False)
        reqs = [Request(request_id=f"r{i}", prompt=p, is_streaming=True)
                for i, p in enumerate(PROMPTS)]
        msgs = _drive(s, reqs)
        stats = w.step_stats()["captured"]
        assert {int(k.split()[2]) for k, c in stats.items()
                if k.startswith("detok ") and c["replays"]} >= {3, 6}
        for r in reqs:
            n = len(r.lm_output_audio_tokens)
            pcm = np.frombuffer(_audio(msgs, r.request_id), np.int16)
            # windows end at 3, 6, 12 (the ramp), then every 10 frames
            assert pcm.size == pcm_samples(n, FS, {3, 6, 12, 22, 32}), n
    finally:
        tm.codec_params, tm.init_decoder_cache = codec, make_cache


def test_http_round_trip(pair, tmp_path):
    """POST /generate to the port's app (speaker 1 as a form field); the
    scheduler runs in this process over the app's ZMQ sockets."""
    from aiohttp.test_utils import TestClient, TestServer

    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=30)
    suffix = f"_torch_csm_{id(tmp_path)}"
    # pages for the model's whole 1200-token budget: admission reserves it
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

    server = APIServer(model_name="csm", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=CSMLM.SAMPLE_RATE))) as client:
            for _ in range(200):
                if (await client.get("/health")).status == 200:
                    break
                await asyncio.sleep(0.05)
            r = await client.post("/generate", data={"text": "hi there",
                                                     "speaker": "1"})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("audio/wav")
            return await r.read()

    try:
        body = asyncio.run(asyncio.wait_for(round_trip(), 120))
    finally:
        stop.set()
        th.join(timeout=30)
        server.cleanup()
        sched.request_socket.close()
        sched.result_socket.close()
    assert body[:4] == b"RIFF"
    assert int.from_bytes(body[24:28], "little") == 24000
    pcm = np.frombuffer(body[44:], np.int16)
    (done,) = sched.completed
    n = done["audio_tokens"]
    assert n == 30 - len("[1]hi there") + 1
    assert pcm.size == pcm_samples(n, FS, {10, 20}) > 0
