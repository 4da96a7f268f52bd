"""Port parity, the TTFA paths (vox_serve_tpu_torch/worker/base.py against
vox_serve_tpu/worker/base.py) on the CPU: the first-chunk ramp's mini
sizes and chunk boundaries through the online scheduler (as
tests/test_first_chunk.py holds the JAX worker), the cold-start chain
against the 2-dispatch path (prefill, then the chained first-chunk decode)
and against the JAX worker's chain, ``can_cold_start``'s conditions, the
fallback to a plain prefill, and the one place the port differs on
purpose: a stream the scheduler already graduated from the ramp keeps its
ramp position when its chained chunk resolves.

Tolerances: greedy tokens exact; the dummy codec's PCM within 2 int16
steps of the JAX package's, the debug Qwen3 codec's within 4.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _qwen3_pair
from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.sampling import SamplingConfig as JSamplingConfig
from vox_serve_tpu.scheduler.online import OnlineScheduler as JOnline
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.ops.kv_cache import PageAllocatorError
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)


def _chunks(sched, rid):
    return [m.split(b"|", 2)[2] for m in sched._inproc_results
            if m.startswith(rid.encode() + b"|")
            and m.split(b"|")[1] == b"AUDIO"]


def _drive(sched, reqs, max_steps=200):
    for r in reqs:
        sched.enqueue_request(r)
    for _ in range(max_steps):
        sched._step()
        if all(r.done_all for r in reqs):
            break
    assert all(r.done_all for r in reqs)


def _greedy_dummies(max_tokens):
    """The dummy in both packages with the port's weights, greedy."""
    tm, jm = DummyLM(max_tokens=max_tokens), JDummyLM(max_tokens=max_tokens)
    jm.params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                             tm.params)
    tm.sampling_config = SamplingConfig(greedy=True, max_tokens=max_tokens)
    jm.sampling_config = JSamplingConfig(greedy=True, max_tokens=max_tokens)
    return tm, jm


@pytest.mark.parametrize("F,ramp", [(2, 0), (1, 0), (2, 8), (3, 12)])
def test_ramp_chunk_boundaries_match_jax(F, ramp):
    """Two streams through the online scheduler with the first-chunk ramp
    and no fused decode (so no cold chain): the same chunk sizes in the same
    order, and the same PCM, as the JAX worker."""
    tm, jm = _greedy_dummies(28)
    kw = dict(max_batch_size=2, num_pages=64, page_size=8,
              prefill_token_buckets=(32,), max_prefill_requests=2,
              first_chunk_frames=F, ramp_frames=ramp)
    tw = ModelWorker(tm, WorkerConfig(**kw))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **kw))
    assert (tw.first_chunk_frames, tw.ramp_frames) == (
        jw.first_chunk_frames, jw.ramp_frames)
    ts = load_scheduler("online", model_worker=tw, max_batch_size=2,
                        connect=False)
    js = JOnline(model_worker=jw, max_batch_size=2, connect=False)
    prompts = ("hello", "ramp me")
    treqs = [Request(request_id=f"s{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(prompts)]
    jreqs = [JRequest(request_id=f"s{i}", prompt=p, is_streaming=True)
             for i, p in enumerate(prompts)]
    _drive(ts, treqs)
    _drive(js, jreqs)
    frame = 2 * DummyLM.SAMPLES_PER_TOKEN
    for t, j in zip(treqs, jreqs):
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
        tc, jc = _chunks(ts, t.request_id), _chunks(js, j.request_id)
        assert [len(c) for c in tc] == [len(c) for c in jc]
        # the first chunk is F frames, not a full interval
        assert len(tc[0]) == F * frame
        np.testing.assert_allclose(
            np.frombuffer(b"".join(tc), np.int16),
            np.frombuffer(b"".join(jc), np.int16), atol=2)
        assert sum(len(c) for c in tc) <= len(t.lm_output_audio_tokens) * \
            frame


CHAIN = dict(max_batch_size=2, num_pages=300, page_size=8,
             max_prefill_requests=2, fused_decode_steps=4,
             fused_decode_buckets=(1,), first_chunk_frames=3)


def test_cold_chain_matches_two_dispatch_and_jax():
    """One stream's cold start: the single-graph chain (prompt in the
    smallest bucket), the 2-dispatch path (prompt beyond it: prefill, then
    the chained first-chunk decode), and the JAX worker's chain give the
    same K+1 greedy tokens, the same 3-frame first chunk, the same ramp
    position, and decode on identically from there."""
    jm, tm = _qwen3_pair(max_tokens=30)
    _, tm2 = _qwen3_pair(max_tokens=30)
    chain = ModelWorker(tm, WorkerConfig(prefill_token_buckets=(32, 128),
                                         **CHAIN))
    two = ModelWorker(tm2, WorkerConfig(prefill_token_buckets=(2, 128),
                                        **CHAIN))
    jw = JWorker(jm, JWorkerConfig(prefill_token_buckets=(32, 128),
                                   warmup=False, **CHAIN))
    reqs = [Request(request_id="c", prompt="hello"),
            Request(request_id="c", prompt="hello"),
            JRequest(request_id="c", prompt="hello")]
    for w, r in zip((chain, two, jw), reqs):
        assert w.can_cold_start(r)
        w.run_cold_start(r)
        w.sync()
        assert len(r.lm_output_tokens) == 4  # prefill + 3 fused steps
        assert r.extras["ramp_next"] == 3 and r.extras["ramp_size"] == 3
    assert chain.cold_starts == {"chain": 1, "two_dispatch": 0,
                                 "prefill": 0}
    assert chain.step_stats()["replays"] == {"cold_chain": 1}
    assert two.cold_starts["two_dispatch"] == 1
    assert two.step_stats()["replays"] == {"prefill": 1,
                                           "decode_multi_detok": 1}
    pcm = [np.frombuffer(r.output_audio.get(), np.int16) for r in reqs]
    assert all(r.output_audio.empty() for r in reqs)
    for r in reqs[1:]:
        np.testing.assert_array_equal(np.stack(r.lm_output_tokens),
                                      np.stack(reqs[0].lm_output_tokens))
    for p in pcm[1:]:
        assert p.shape == pcm[0].shape and p.size
        assert np.abs(p.astype(np.int32) - pcm[0]).max() <= 4
    # the feedback token, KV and slot state the chain left behind
    for w, r in zip((chain, two, jw), reqs):
        for _ in range(3):
            w.run_lm_decode([r])
        w.sync()
    for r in reqs[1:]:
        np.testing.assert_array_equal(np.stack(r.lm_output_tokens),
                                      np.stack(reqs[0].lm_output_tokens))


def test_cold_chain_through_the_online_scheduler():
    """A solo stream served by the online scheduler takes the cold chain;
    its tokens equal those of the path without a first-chunk ramp, its
    first chunk is 3 frames and its audio covers the same samples."""
    outs = []
    for fc in (3, 0):
        _, tm = _qwen3_pair(max_tokens=30)
        w = ModelWorker(tm, WorkerConfig(prefill_token_buckets=(32, 128),
                                         **{**CHAIN,
                                            "first_chunk_frames": fc}))
        s = load_scheduler("online", model_worker=w, max_batch_size=2,
                           connect=False)
        r = Request(request_id="solo", prompt="hello", is_streaming=True)
        _drive(s, [r])
        outs.append((r, _chunks(s, "solo"), w))
    (r, chunks, w), (r0, chunks0, w0) = outs
    assert w.cold_starts["chain"] == 1 and w0.cold_starts["chain"] == 0
    np.testing.assert_array_equal(np.stack(r.lm_output_tokens),
                                  np.stack(r0.lm_output_tokens))
    per_frame = w.model.output_audio_length // w.detokenize_interval
    assert len(chunks[0]) == 3 * per_frame * 2
    a = np.frombuffer(b"".join(chunks), np.int16)
    b = np.frombuffer(b"".join(chunks0), np.int16)
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b).max() <= 4


class _NoChainDummy(DummyLM):
    supports_chained_detok = False


class _JNoChainDummy(JDummyLM):
    supports_chained_detok = False


@pytest.mark.parametrize("fused,F,buckets,chained,streaming_input", [
    (4, 3, (1,), True, False),
    (0, 3, (1,), True, False),
    (4, 0, (1,), True, False),
    (4, 1, (1,), True, False),
    (4, 2, (1, 4), True, False),
    (4, 3, (2,), True, False),
    (4, 3, (1,), False, False),
    (4, 3, (1,), True, True),
    (2, 3, (1,), True, False),
])
def test_can_cold_start_matches_jax(fused, F, buckets, chained,
                                    streaming_input):
    tm = DummyLM() if chained else _NoChainDummy()
    jm = JDummyLM() if chained else _JNoChainDummy()
    kw = dict(max_batch_size=4, num_pages=64, page_size=8,
              prefill_token_buckets=(32,), fused_decode_steps=fused,
              fused_decode_buckets=buckets, first_chunk_frames=F)
    tw = ModelWorker(tm, WorkerConfig(**kw))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **kw))
    tr = Request(request_id="x", is_input_streaming=streaming_input)
    jr = JRequest(request_id="x", is_input_streaming=streaming_input)
    assert tw.can_cold_start(tr) == jw.can_cold_start(jr)
    assert tw.can_cold_start(tr) == (
        fused >= 2 and F >= 2 and chained and not streaming_input)
    # the chained graphs are warmed exactly when a cold start can run
    kinds = {k[0] for k in tw.warmup_keys()}
    assert ("cold_chain" in kinds) == (fused >= 2 and F >= 2 and chained)


def test_kv_backpressure_falls_back_to_a_plain_prefill(monkeypatch):
    """When the fused leg cannot take its pages the chain is undone and the
    request prefills alone, as in the JAX worker."""
    m = DummyLM()
    m.sampling_config = SamplingConfig(greedy=True, max_tokens=16)
    w = ModelWorker(m, WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=4,
        prefill_token_buckets=(8, 32), fused_decode_steps=4,
        fused_decode_buckets=(1,), first_chunk_frames=3))
    admit = w._admit_prefills

    def admit_then_fill(reqs):
        out = admit(reqs)

        def full(*a, **k):
            raise PageAllocatorError("pool exhausted")
        monkeypatch.setattr(w.allocator, "alloc", full)
        return out

    monkeypatch.setattr(w, "_admit_prefills", admit_then_fill)
    req = Request(request_id="bp", prompt="ab")  # KV at 2, 3, 4: a new page
    w.run_cold_start(req)
    assert w.cold_starts == {"chain": 0, "two_dispatch": 0, "prefill": 1}
    assert w.step_stats()["replays"] == {"prefill": 1}
    # the prefill resolved at once (pipeline depth 0): one token, no audio
    assert req.done_lm_prefill and req.extras["inflight"] == 0
    assert req.kv_token_len == 2
    assert len(req.lm_output_tokens) == 1 and req.output_audio.empty()


@pytest.mark.parametrize("before,after", [
    (None, 3), (0, 3), (3, 3), (6, 6), (12, 12)])
def test_graduated_ramp_position_survives_the_chained_chunk(before, after):
    """The chained first chunk (3 frames) sets the ramp position to 3, as
    the JAX worker does, unless the stream is already at or past it; there
    the JAX worker moves it back (putting a graduated stream back on the
    mini ramp), and the port keeps it: different on purpose."""
    tw = ModelWorker(DummyLM(), WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(32,), fused_decode_steps=4,
        first_chunk_frames=3))
    jw = JWorker(JDummyLM(), JWorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(32,), fused_decode_steps=4,
        first_chunk_frames=3, warmup=False))
    pcm = np.zeros((1, 3 * DummyLM.SAMPLES_PER_TOKEN), np.int16)
    got = []
    for w, cls in ((tw, Request), (jw, JRequest)):
        r = cls(request_id="g")
        r.lm_output_audio_tokens = [np.zeros((1,), np.int32)] * 14
        if before is not None:
            r.extras["ramp_next"] = before
            r.extras["ramp_size"] = 4
        w._emit_cold_chunk(r, pcm, 3)
        assert r.output_audio.get() == pcm.tobytes()
        got.append(r.extras["ramp_next"])
    assert got[0] == after
    assert got[1] == 3  # the JAX worker always writes the window
