"""Port parity, Orpheus-3B (vox_serve_tpu_torch/models/orpheus.py) against
the JAX package's OrpheusLM, on the CPU at small widths (float32, the same
weights in both packages, inputs from numpy seeds).

* prompt ids and the detokenize window's regroup / remap equal to JAX;
* a small Llama backbone at Orpheus's GQA group of 3 (6 query heads over
  2 KV heads, head dim 16, rope theta 5e5 with Llama-3.1 scaling): a
  ragged prefill of two prompts and three decode steps at 1e-4;
* the whole model through the port's worker and scheduler against the JAX
  worker and scheduler, greedy: equal tokens over >= 40 steps, and PCM
  within 1e-4 of max |ref| (plus one int16 step of rounding) over >= 3
  overlapped windows and a final window of fewer than 28 tokens; each
  stream's PCM length is what the overlap rule gives for its token count;
* the overlap codec turns the first-chunk ramp off (``first_chunk_frames``
  0 even when asked for 3), as in the JAX worker;
* one HTTP round trip: the port's app over an in-process scheduler.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _audio, _drive
from test_torch_models import ATOL, Plan, _i, _np_tree
from vox_serve_tpu.codecs.snac import SNACConfig as JSNACConfig
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import orpheus as jorph_mod
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.snac import SNACConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.orpheus import (PROMPT_END, PROMPT_START,
                                                OrpheusLM)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

#: Orpheus's head layout cut to size: G = 3, Llama-3.1 rope scaling
BB = dict(vocab_size=156940, hidden_size=64, num_layers=2, num_heads=6,
          num_kv_heads=2, head_dim=16, intermediate_size=128,
          rope_theta=500000.0, llama31_rope_scaling=True)
SNAC = dict(decoder_dim=64, decoder_rates=(8, 8, 4, 2), latent_dim=32,
            codebook_size=4096, codebook_dim=8, vq_strides=(4, 2, 1),
            depthwise=True)
PROMPTS = ("hi there", "hello, friend!")
STEPS = 48  # generated tokens per stream (max_tokens = prompt + STEPS - 1)


class _JOrpheus(jorph_mod.OrpheusLM):
    """The JAX model with its weights supplied by the test."""

    def _load_params(self):
        self.params, self.codec_params = {}, {}


@pytest.fixture(scope="module")
def pair():
    """The small Orpheus in both packages with the port's random weights."""
    tm = OrpheusLM(dtype=torch.float32, seed=3,
                   debug_backbone=tbb.BackboneConfig(**BB,
                                                     dtype=torch.float32),
                   debug_codec=SNACConfig(**SNAC))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jorph_mod, "load_text_tokenizer",
                   lambda name, vocab: (JDevTokenizer(vocab), False))
        jm = _JOrpheus(dtype=jnp.float32,
                       debug_backbone=jbb.BackboneConfig(**BB,
                                                         dtype=jnp.float32),
                       debug_codec=JSNACConfig(**SNAC))
    to_np = (lambda t: t.numpy())
    jm.params = jax.tree.map(jnp.asarray, tparams.tree_map(to_np, tm.params))
    jm.codec_params = jax.tree.map(jnp.asarray,
                                   tparams.tree_map(to_np, tm.codec_params))
    return jm, tm


def test_registry_and_full_width_config():
    assert get_model_class("orpheus") is OrpheusLM
    assert get_model_class("canopylabs/orpheus-3b-0.1-ft") is OrpheusLM
    cfg = tbb.BackboneConfig(
        vocab_size=156940, hidden_size=3072, num_layers=28, num_heads=24,
        num_kv_heads=8, head_dim=128, intermediate_size=8192,
        rope_theta=500000.0, llama31_rope_scaling=True)
    with torch.device("meta"):
        meta = OrpheusLM(device="meta")
    assert meta.backbone_config == cfg
    assert meta.codec_config == SNACConfig()
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params))
    assert 3.7e9 < n < 3.9e9  # Llama-3.2-3B with an untied 156,940 head
    assert meta.output_audio_length == 2048 and meta.SAMPLE_RATE == 24000
    assert (meta.detokenize_interval, meta.detokenize_overlap) == (28, 21)
    sc = meta.default_sampling_config
    assert (sc.top_p, sc.temperature, sc.repetition_penalty,
            sc.repetition_window, sc.max_tokens) == (0.8, 0.6, 1.3, -1, 1024)


@pytest.mark.parametrize("prompt,voice", [("hello world", "tara"),
                                          ("x", "zoe"), ("", None)])
def test_prompt_ids_match_jax(pair, prompt, voice):
    jm, tm = pair
    ids = tm.preprocess(prompt=prompt, voice=voice).input_tokens
    np.testing.assert_array_equal(
        ids, jm.preprocess(prompt=prompt, voice=voice).input_tokens)
    assert ids.shape[1] == 1 and ids.dtype == np.int32
    assert ids[0, 0] == PROMPT_START and list(ids[-4:, 0]) == PROMPT_END
    with pytest.raises(ValueError):
        tm.preprocess(prompt="x", voice="nobody")


def test_detokenize_regroup_matches_jax(pair):
    """(B, 28, 1) windows of ids across the whole vocab (the remap makes
    each a valid code): the same codes reach SNAC in both packages."""
    jm, tm = pair
    rng = np.random.default_rng(0)
    win = rng.integers(0, 156940, (3, 28, 1)).astype(np.int32)
    ref, none = jm.detokenize(jm.codec_params, jnp.asarray(win), None)
    got, cache = tm.detokenize(tm.codec_params, torch.from_numpy(win), None)
    assert cache is None and none is None
    assert tuple(got.shape) == (3, 1, tm.output_audio_length)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # the regroup itself, as the reference formula writes it
    mf = (win[:, :, 0].reshape(3, 4, 7) - 128266) % 4096
    codes = [mf[:, :, 0], mf[:, :, [1, 4]].reshape(3, 8),
             mf[:, :, [2, 3, 5, 6]].reshape(3, 16)]
    from vox_serve_tpu_torch.codecs.snac import snac_decode

    full = snac_decode(tm.codec_params, tm.codec_config,
                       [torch.from_numpy(c) for c in codes])
    torch.testing.assert_close(got, full[:, :, 2048:4096], rtol=0, atol=0)


def test_g3_llama31_backbone_prefill_and_decode_match_jax():
    jcfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**BB, dtype=torch.float32)
    jp = jbb.init_backbone_params(jcfg, jax.random.key(5))
    tp = tparams.tree_to_torch(_np_tree(jp), "cpu", torch.float32)
    plan = Plan(lens=(11, 6))
    shape = (2, plan.P, plan.page, 2 * BB["num_kv_heads"], BB["head_dim"])
    jpool = jnp.zeros(shape, jnp.float32)
    tpool = torch.zeros(shape)
    rng = np.random.default_rng(5)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool,
                                            None)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tpool)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)


def overlap_pcm_samples(n_tokens: int, interval: int = 28, overlap: int = 21,
                        window: int = 2048) -> int:
    """The PCM a stream of ``n_tokens`` audio tokens emits: windows every
    ``interval - overlap`` tokens until one reaches the last token, each
    ``window`` samples, a final window of fewer than ``interval - overlap``
    tokens trimmed (worker ``_resolve_detok``, scheduler window
    selection)."""
    step, s, total = interval - overlap, 0, 0
    while True:
        last = min(interval, n_tokens - s)
        total += window if last >= step else max(
            int(window * (last - 0.5) / step), 0)
        if s + interval >= n_tokens:
            return total
        s += step


def test_overlap_rule_counts_windows():
    assert overlap_pcm_samples(28) == 2048
    assert overlap_pcm_samples(29) == 2 * 2048
    assert overlap_pcm_samples(50) == 5 * 2048
    assert overlap_pcm_samples(3) == int(2048 * 2.5 / 7)


def _serve_pair(jm, tm, **kw):
    n_max = {p: len(tm.preprocess(prompt=p).input_tokens) + STEPS - 1
             for p in PROMPTS}
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=max(n_max.values()))
    cfg = dict(max_batch_size=2, num_pages=256, page_size=16,
               prefill_token_buckets=(64,), max_prefill_requests=2, **kw)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jreqs = [JRequest(request_id=f"j{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(PROMPTS)]
    treqs = [Request(request_id=f"t{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(PROMPTS)]
    jmsgs = _drive(JScheduler(model_worker=jw, max_batch_size=2,
                              connect=False), jreqs)
    tsched = load_scheduler("base", model_worker=tw, max_batch_size=2,
                            connect=False)
    tmsgs = _drive(tsched, treqs)
    return jw, tw, jreqs, treqs, jmsgs, tmsgs, tsched


def test_worker_streams_match_jax_worker(pair):
    jm, tm = pair
    jw, tw, jreqs, treqs, jmsgs, tmsgs, tsched = _serve_pair(jm, tm)
    assert jw.first_chunk_frames == tw.first_chunk_frames == 0
    for j, t in zip(jreqs, treqs):
        assert j.done_all and t.done_all and t.finish_reason == "length"
        assert len(t.lm_output_tokens) >= 40
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
        n = len(t.lm_output_audio_tokens)
        # windows at tokens 0, 7 and 14 of 28 tokens each, then a last one
        # of fewer than 28
        assert n >= 2 * 7 + 28 and (n - 28) % 7
        ja = np.frombuffer(_audio(jmsgs, j.request_id), np.int16)
        ta = np.frombuffer(_audio(tmsgs, t.request_id), np.int16)
        assert ta.size == ja.size == overlap_pcm_samples(n)
        ref = ja.astype(np.int32)
        err = np.abs(ta.astype(np.int32) - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1, err
    assert {c["request_id"]: (c["audio_tokens"], c["finish_reason"])
            for c in tsched.completed} == {
        t.request_id: (len(t.lm_output_audio_tokens), "length")
        for t in treqs}
    # the stateless codec keeps no slot cache; only the interval's window
    assert tw.codec_cache is None
    assert tw._detok_lengths() == [28]


@pytest.mark.parametrize("sched_type", ["base", "online"])
def test_fused_pipelined_decode_keeps_tokens_and_audio(pair, sched_type):
    """``--fused-decode-steps 4`` with ``--pipeline-depth 2`` serve Orpheus
    as they serve Qwen3: the same greedy tokens and the same windows as
    single-step decode. The codec is stateless (one 28-token window per
    detokenize, no catch-up windows), so the PCM has the same length; its
    samples agree to one int16 step, since the windows meet the codec in
    batches of another size, whose convolutions round differently."""
    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=70)

    def serve(**kw):
        w = ModelWorker(tm, WorkerConfig(
            max_batch_size=2, num_pages=256, page_size=16,
            prefill_token_buckets=(64,), max_prefill_requests=2, **kw))
        s = load_scheduler(sched_type, model_worker=w, max_batch_size=2,
                           connect=False)
        reqs = [Request(request_id=f"f{i}", prompt=p, is_streaming=True,
                        is_pressing=True) for i, p in enumerate(PROMPTS)]
        msgs = _drive(s, reqs)
        assert all(r.done_all for r in reqs)
        return w, [(np.stack(r.lm_output_tokens),
                    np.frombuffer(_audio(msgs, r.request_id), np.int16))
                   for r in reqs]

    _, single = serve()
    w, fused = serve(fused_decode_steps=4, fused_decode_buckets=(2,),
                     pipeline_depth=2)
    assert w.step_stats()["replays"].get("decode_multi", 0) > 0
    for (tf, af), (ts, as_) in zip(fused, single):
        np.testing.assert_array_equal(tf, ts)
        assert af.size == as_.size == overlap_pcm_samples(len(ts))
        assert np.abs(af.astype(np.int32) - as_).max() <= 1


def test_overlap_codec_turns_the_first_chunk_ramp_off(pair):
    jm, tm = pair
    kw = dict(max_batch_size=2, num_pages=64, page_size=16,
              prefill_token_buckets=(64,), first_chunk_frames=3)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **kw))
    tw = ModelWorker(tm, WorkerConfig(**kw))
    assert jw.first_chunk_frames == tw.first_chunk_frames == 0
    assert tw.ramp_frames == 0 and not tw._chains_enabled()
    assert not any(k[0] in ("cold_chain", "decode_multi_detok")
                   for k in tw.warmup_keys())


def test_http_round_trip(pair, tmp_path):
    """POST /generate to the port's app; the scheduler runs in this
    process over the app's ZMQ sockets."""
    from aiohttp.test_utils import TestClient, TestServer

    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=50)
    suffix = f"_torch_orpheus_{id(tmp_path)}"
    # pages for the model's whole 1024-token budget: admission reserves it
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=160, page_size=16,
        prefill_token_buckets=(64,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="orpheus", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=OrpheusLM.SAMPLE_RATE))) as client:
            for _ in range(200):
                if (await client.get("/health")).status == 200:
                    break
                await asyncio.sleep(0.05)
            r = await client.post("/generate", data={"text": "hi there"})
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
    assert pcm.size == overlap_pcm_samples(done["audio_tokens"]) > 0
