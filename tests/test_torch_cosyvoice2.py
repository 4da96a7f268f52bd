"""Port parity, CosyVoice2-0.5B (vox_serve_tpu_torch/models/cosyvoice2.py
and models/flow_common.py) against the JAX package's CosyVoice2LM, on the
CPU in float32 at the JAX CosyVoice2 test's small widths (``SMALL_BACKBONE``,
``SMALL_COSY_FLOW``, ``SMALL_HIFT``), with the port's random weights in
both packages.

* the registry names and the published widths (on the meta device);
* a 2-layer Qwen2-style backbone at a GQA group of 2 with q/k/v, o and MLP
  biases: a ragged prefill and three decode steps at 1e-4;
* the prompt rows (ids, masks, feature rows) equal to JAX's; the stop ids;
  a voice clone's cache row (x-vector, context tokens, ``tok_pos``) equal
  to JAX's ``make_flow_cache_row``;
* the window tiling of the flow codec (``test_flow_window_tiling.py``'s
  oracle): windows tile the stream from token 0, with no gap or repeat;
* the port's worker against the JAX worker over one stream: greedy tokens
  equal over 110 steps, then four windows (28 tokens at 0, a 53-token
  catch-up window at 25, 28 at 75 and a final partial window at 100) with
  the JAX noise in the port's noise buffers: PCM lengths equal and the
  samples within 4 int16 steps of ~3,300 peak (the flow's 1e-4 relative,
  the source phase's float32 cumsum drift; measured: 1 in every window),
  ``tok_pos`` advanced by the emitted tokens;
* two streams through the online scheduler with decode and detokenize two
  deep: the same tokens and windows as synchronous serving;
* an HTTP round trip through the port's app over an in-process scheduler.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import OVERLAP_WINDOWS
from chip_smoke import overlap_pcm_samples as _overlap_rule
from test_torch_fused_decode import _audio, _drive
from test_torch_models import ATOL, Plan, _i
from vox_serve_tpu.codecs.cosyvoice_flow import CosyFlowConfig as JFlowCfg
from vox_serve_tpu.codecs.hifigan import HiFTConfig as JHiFTCfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import cosyvoice2 as jcosy_mod
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.weights import DevTokenizer as JDevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.cosyvoice_flow import CosyFlowConfig
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import flow_common as tfc
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.cosyvoice2 import (SOS, STOP_IDS, TASK_ID,
                                                   CosyVoice2LM)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=151936, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qkv_bias=True,
          rope_theta=1_000_000.0)
FLOW = dict(input_size=32, output_size=32, heads=4, linear_units=64,
            num_blocks=1, up_blocks=1, vocab_size=6561, spk_dim=8,
            mel_dim=16, est_channels=16, est_head_dim=8, est_heads=2,
            est_n_blocks=1, est_mid_blocks=1, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=4,
            upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
            f0_cond_channels=16)
PCM_STEPS = 4  # int16 steps
STEPS = 110     # generated tokens of the worker stream


def overlap_pcm_samples(n_tokens: int) -> int:
    """The smoke's overlap rule with CosyVoice2's windows: 24,000 samples
    per 25 tokens, the last window trimmed."""
    return _overlap_rule(n_tokens, *OVERLAP_WINDOWS["cosyvoice2"])


def small_model(seed=3) -> CosyVoice2LM:
    return CosyVoice2LM(
        dtype=torch.float32, seed=seed,
        debug_backbone=tbb.BackboneConfig(**BB, dtype=torch.float32),
        debug_flow=CosyFlowConfig(**FLOW), debug_hift=HiFTConfig(**HIFT))


class _JCosy(jcosy_mod.CosyVoice2LM):
    """The JAX model with the port's weights (no JAX init)."""

    def __init__(self, tm: CosyVoice2LM):
        jcosy_mod.BaseLM.__init__(self, tm.model_name, jnp.float32)
        self._cfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
        self._flow_cfg = JFlowCfg(**FLOW)
        self._hift_cfg = JHiFTCfg(**HIFT)
        self.text_tokenizer = JDevTokenizer(BB["vocab_size"])
        self.assets_available = False
        to_np = (lambda t: t.numpy())
        self.params = jax.tree.map(jnp.asarray, tparams.tree_map(
            to_np, {**tm.params, "text_embed": tm.text_embed}))
        self.codec_params = jax.tree.map(jnp.asarray, tparams.tree_map(
            to_np, tm.codec_params))
        self.default_ref = {
            "ref_text_ids": np.zeros((0,), np.int32),
            "ref_speech_tokens": np.zeros((0,), np.int32),
            "spk": np.zeros((FLOW["spk_dim"],), np.float32)}
        self.sampling_config = self.default_sampling_config


@pytest.fixture(scope="module")
def pair():
    tm = small_model()
    return _JCosy(tm), tm


def test_registry_and_full_width_config():
    for name in ("cosyvoice2", "cosyvoice2-0.5b",
                 "FunAudioLLM/CosyVoice2-0.5B"):
        assert get_model_class(name) is CosyVoice2LM
    with torch.device("meta"):
        meta = CosyVoice2LM(device="meta")
    assert meta.backbone_config == tbb.BackboneConfig(
        vocab_size=151936, hidden_size=896, num_layers=24, num_heads=14,
        num_kv_heads=2, intermediate_size=4864, qkv_bias=True,
        rope_theta=1_000_000.0)
    assert meta.backbone_config.resolved_head_dim == 64
    assert meta.flow_config == CosyFlowConfig()
    assert meta.hift_config == HiFTConfig()
    n = sum(t.numel() for t in tparams.tree_leaves(meta.params))
    assert 3.6e8 < n < 3.8e8  # 24 Qwen2 layers + speech tables + head
    assert tuple(meta.text_embed.shape) == (151936, 896)
    assert meta.output_audio_length == 24000
    assert (meta.detokenize_interval, meta.detokenize_overlap) == (28, 3)
    assert meta.vocab_size == 6564 and meta.max_tokens == 4096
    sc = meta.default_sampling_config
    assert (sc.top_k, sc.temperature) == (25, 1.0)
    assert not any(meta.checkpoint_parts.values())
    assert set(meta.checkpoint_parts) == {"backbone", "flow", "hift", "s3v2",
                                          "campplus"}


def test_biased_backbone_prefill_and_decode_match_jax():
    kw = dict(BB, vocab_size=512, o_bias=True, mlp_bias=True)
    jcfg = jbb.BackboneConfig(**kw, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**kw, dtype=torch.float32)
    tp = tbb.init_backbone_params(tcfg, tbb.seeded_generator("cpu", 5), "cpu")
    biases = [lin["b"] for lin in (*tp["layers"]["attn"].values(),
                                   *tp["layers"]["mlp"].values())]
    assert len(biases) == 7
    g = torch.Generator().manual_seed(6)
    for b in biases:
        b.copy_(torch.randn(b.shape, generator=g) * 0.1)
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
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)
    # the JAX init makes the same tree (with zero biases)
    jinit = jbb.init_backbone_params(jcfg, jax.random.key(0))
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, jinit))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, tp)))


@pytest.mark.parametrize("prompt", ["hello cosy world", "", "x"])
def test_prompt_rows_match_jax(pair, prompt):
    jm, tm = pair
    got, ref = tm.preprocess(prompt=prompt), jm.preprocess(prompt=prompt)
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    np.testing.assert_array_equal(got.input_features, ref.input_features)
    ids = got.input_tokens[:, 0]
    assert ids[0] == SOS and ids[-1] == TASK_ID
    assert len(ids) == len(prompt) + 2  # the dev tokenizer: one id a char
    assert got.input_features.dtype == np.float32 and got.input_masks.all()
    assert got.decoder_cache_init is None  # the neutral voice


def test_stop_ids_and_embed(pair):
    jm, tm = pair
    for sid in STOP_IDS:
        assert tm.is_stop(np.array([sid], np.int32))
    assert not tm.is_stop(np.array([100], np.int32))
    ids = np.array([[0], [5], [6563], [7000]], np.int32)
    feats = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)
    masks = np.array([[True], [False], [True], [False]])
    for f, m in ((None, None), (feats, masks)):
        got = tm.embed(tm.params, torch.from_numpy(ids),
                       None if f is None else torch.from_numpy(f),
                       None if m is None else torch.from_numpy(m))
        ref = jm.embed(jm.params, jnp.asarray(ids),
                       None if f is None else jnp.asarray(f),
                       None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    h = torch.from_numpy(feats)
    np.testing.assert_allclose(tm.logits(tm.params, h).numpy(),
                               np.asarray(jm.logits(jm.params,
                                                    jnp.asarray(feats))),
                               atol=1e-5)


def test_clone_cache_row_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    spk = rng.standard_normal(FLOW["spk_dim"]).astype(np.float32)
    for n in (7, 25, 60):
        toks = rng.integers(0, 7000, n)
        got = tm.make_flow_cache_row(spk=spk, prompt_tokens=toks)
        ref = jm.make_flow_cache_row(spk=spk, prompt_tokens=toks)
        flat_g, flat_r = jax.tree.leaves(got), jax.tree.leaves(ref)
        assert len(flat_g) == len(flat_r)
        for g, r in zip(flat_g, flat_r):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    feat = rng.standard_normal((40, FLOW["mel_dim"])).astype(np.float32)
    got = tm.make_flow_cache_row(prompt_feat=feat)
    ref = jm.make_flow_cache_row(prompt_feat=feat)
    np.testing.assert_array_equal(got["prompt_feat"].numpy(),
                                  np.asarray(ref["prompt_feat"]))
    assert int(got["prompt_len"]) == int(ref["prompt_len"]) == 40


def test_windows_tile_from_token_zero(pair, monkeypatch):
    """The flow windows tile the stream from token 0 (the oracle of
    tests/test_flow_window_tiling.py), through the port's mixin with the
    flow and HiFT replaced by identities over the token ids."""
    _, tm = pair
    r = tm.flow_config.token_mel_ratio
    K, W = tm.FLOW_CTX_TOKENS, tm.detokenize_interval
    step = W - tm.detokenize_overlap

    def fake_flow(params, cfg_, tokens, valid, spk, conds, *, noise,
                  streaming=True):
        B, T = tokens.shape
        mel = torch.repeat_interleave(tokens.float(), r, dim=1)[:, None, :]
        return mel.expand(B, cfg_.mel_dim, r * T)

    def fake_hift_chunk(params, hcfg, mel, cache):
        return mel[:, 0, :], cache

    monkeypatch.setattr(tfc, "cosy_flow_forward", fake_flow)
    monkeypatch.setattr(tfc, "hift_decode_chunk", fake_hift_chunk)
    cache = tm.init_decoder_cache(1)
    N = step * 2 + W
    stream = np.arange(1, N + 1, dtype=np.int32)
    out = []
    for i in range(3):
        win = torch.from_numpy(stream[i * step: i * step + W])[None, :, None]
        wav, cache = tm.detokenize(tm.codec_params, win, cache)
        out.append(wav[0, 0].numpy())
    np.testing.assert_array_equal(
        np.concatenate(out), np.repeat(stream[:3 * step], r).astype(
            np.float32))
    assert int(cache["tok_pos"][0]) == 3 * step
    np.testing.assert_array_equal(cache["ctx_tokens"][0].numpy(),
                                  stream[3 * step - K: 3 * step])


def _drain(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return np.frombuffer(out, np.int16)


def test_worker_windows_match_jax_worker(pair):
    jm, tm = pair
    n_prompt = len(tm.preprocess(prompt="hello cosy world").input_tokens)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + STEPS - 1)
    # the JAX worker's noise (jax.random.key(0) per window length) in the
    # port's noise buffers
    for W in (28, 53):
        T2 = 2 * (tm.FLOW_CTX_TOKENS + W)
        tm._flow_noise[T2] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(0), (1, FLOW["mel_dim"], T2))))
    cfg = dict(max_batch_size=2, num_pages=64, page_size=16,
               prefill_token_buckets=(64,), max_prefill_requests=2)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    assert tw._detok_lengths() == [28, 103, 53]
    assert tw.first_chunk_frames == jw.first_chunk_frames == 0
    jr = JRequest(request_id="j", prompt="hello cosy world")
    tr = Request(request_id="t", prompt="hello cosy world")
    for w, r in ((jw, jr), (tw, tr)):
        w.run_lm_prefill([r])
        while not r.done_lm_generation:
            w.run_lm_decode([r])
    np.testing.assert_array_equal(np.stack(tr.lm_output_tokens),
                                  np.stack(jr.lm_output_tokens))
    assert len(tr.lm_output_audio_tokens) == STEPS
    assert tr.finish_reason == "length"

    slot = tr.slot
    # 28 at 0; a 53-token catch-up window at 25 (two ready windows, k=2);
    # 28 at 75; the final partial window at 100 (10 tokens of 25)
    for idx, L, n_out in (([0], 28, 25), ([25, 50], 53, 50), ([75], 28, 25),
                          ([100], 28, 10)):
        outs = []
        for w, r in ((jw, jr), (tw, tr)):
            r.next_audio_decode_idx = list(idx)
            w.run_detokenize([r])
            w.flush_detokenize()
            outs.append(_drain(r))
        ja, ta = outs
        full = (L - 3) * 2 * 480
        expect = full if n_out >= 25 or L > 28 else int(
            full * (n_out - 0.5) / 25)
        assert ta.size == ja.size == expect, idx
        err = np.abs(ta.astype(np.int32) - ja).max()
        assert err <= PCM_STEPS, (idx, err)
        assert np.abs(ja).max() > 100, idx  # not silence
    # the slot's cache advanced by the emitted tokens of every window
    assert int(tw.codec_cache["tok_pos"][slot]) == 125
    assert bool(tw.codec_cache["hift"]["primed"][slot])
    assert tr.done_all


def test_pipelined_scheduler_keeps_tokens_and_windows(pair):
    """Two streams through the online scheduler with decode and detokenize
    two deep (``--pipeline-depth 2 --detok-pipeline-depth 2``) against
    synchronous: the same greedy tokens, each stream's PCM by the trim
    rule, the samples within 4 int16 steps, and each slot's ``tok_pos`` at
    the tokens its windows emitted. Every window of a stream reads the
    cache row the window before it left (one window per stream per batch,
    replayed in order), so the streams match with or without catch-up
    windows."""
    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=75)

    def serve(**kw):
        w = ModelWorker(tm, WorkerConfig(
            max_batch_size=2, num_pages=560, page_size=16,
            prefill_token_buckets=(64,), max_prefill_requests=2, **kw))
        s = load_scheduler("online", model_worker=w, max_batch_size=2,
                           connect=False)
        reqs = [Request(request_id=f"p{i}", prompt=p, is_streaming=True,
                        is_pressing=True)
                for i, p in enumerate(("hello cosy", "a second stream"))]
        msgs = _drive(s, reqs)
        assert all(r.done_all for r in reqs)
        return w, [(np.stack(r.lm_output_tokens),
                    np.frombuffer(_audio(msgs, r.request_id), np.int16))
                   for r in reqs]

    _, sync = serve()
    w, piped = serve(pipeline_depth=2, detok_pipeline_depth=2)
    assert w._detok_depth == 2
    for (tp_, ap), (ts, as_) in zip(piped, sync):
        np.testing.assert_array_equal(tp_, ts)
        n = len(ts)
        assert ap.size == as_.size == overlap_pcm_samples(n) > 0
        assert np.abs(ap.astype(np.int32) - as_).max() <= 4


def test_http_round_trip(pair, tmp_path):
    """POST /generate to the port's app; the scheduler runs in this
    process over the app's ZMQ sockets. The PCM is 24,000 samples per 25
    tokens, the last window trimmed."""
    from aiohttp.test_utils import TestClient, TestServer

    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    _, tm = pair
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=60)
    suffix = f"_torch_cosy_{id(tmp_path)}"
    # pages for the model's whole 4096-token budget: admission reserves it
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=560, page_size=16,
        prefill_token_buckets=(64,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="cosyvoice2", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=CosyVoice2LM.SAMPLE_RATE))) as client:
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
    n = done["audio_tokens"]
    assert n > 28
    assert pcm.size == overlap_pcm_samples(n)
