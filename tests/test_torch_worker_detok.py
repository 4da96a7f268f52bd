"""Port parity, worker detokenize (vox_serve_tpu_torch/worker/base.py
against vox_serve_tpu/worker/base.py) on the CPU: the detokenize-batch
lattice, its frame-budget cap and bucket choice, the online scheduler's
detokenize batch cap, pipelined audio readback at depth 0/1/2 against
synchronous, multi-chunk catch-up windows (the oracle of
tests/test_multi_chunk_detok.py), the frame-budget split,
``flush_detokenize`` and ``poll_resolved``, padded rows against the slot
codec rows, and a model's own initial codec-cache row.

Tolerances: the dummy codec's audio is byte-exact between the port's own
paths and within 2 int16 steps of the JAX package's (a float32 phase
cumsum in another order); the debug Qwen3 codec's within 4 steps.
"""

import numpy as np
import pytest
import torch

from test_torch_worker_decode import _pair_workers, debug_qwen3
from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.online import OnlineScheduler as JOnline
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.models.base import PreprocessOutput
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.params import tree_leaves
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

S = DummyLM.SAMPLES_PER_TOKEN


def _worker(model=None, **kw):
    cfg = dict(max_batch_size=4, num_pages=64, page_size=8,
               prefill_token_buckets=(64,), max_prefill_requests=4)
    cfg.update(kw)
    return ModelWorker(model or DummyLM(max_tokens=64), WorkerConfig(**cfg))


def _req_with_audio(worker, rid, n_tokens, seed=7, cls=Request):
    req = cls(request_id=rid)
    worker.admit(req)
    rng = np.random.default_rng(seed)
    C = worker.model.n_codebooks
    req.lm_output_audio_tokens = [
        rng.integers(0, 60, size=(C,)).astype(np.int32)
        for _ in range(n_tokens)]
    return req


def _drain_pcm(req):
    out = b""
    while not req.output_audio.empty():
        out += req.output_audio.get()
    return out


# -- the lattice, its cap and bucket --------------------------------------

LATTICES = [
    dict(max_batch_size=4),
    dict(max_batch_size=8),
    dict(max_batch_size=6, decode_buckets_override=(2, 6)),
    dict(max_batch_size=8, detok_buckets_override=(2, 4)),
    dict(max_batch_size=8, detok_buckets_override=(1, 2, 4),
         detok_frame_budget=16),
    dict(max_batch_size=4, detok_frame_budget=0),
    dict(max_batch_size=16, detok_frame_budget=40),
]


@pytest.mark.parametrize("kw", LATTICES)
def test_detok_lattice_cap_and_bucket_match_jax(kw):
    tw, jw = _pair_workers(num_pages=64, page_size=8, **kw)
    assert tw.config.detok_buckets == jw.config.detok_buckets
    for L in range(1, 48):
        assert tw._detok_cap(L) == jw._detok_cap(L), L
        for n in range(1, kw["max_batch_size"] + 1):
            assert tw._detok_bucket(n, L) == jw._detok_bucket(n, L), (n, L)


def test_detok_buckets_override_above_max_batch_raises():
    with pytest.raises(ValueError, match="exceed"):
        WorkerConfig(max_batch_size=4,
                     detok_buckets_override=(2, 8)).detok_buckets


def _interval_dummies(interval):
    class T(DummyLM):
        detokenize_interval = property(lambda self: interval)

    class J(JDummyLM):
        detokenize_interval = property(lambda self: interval)

    return T(), J()


@pytest.mark.parametrize("interval", [4, 10])
@pytest.mark.parametrize("kw", [
    dict(max_batch_size=4),
    dict(max_batch_size=4, fused_decode_steps=4, fused_decode_buckets=(1, 4)),
    dict(max_batch_size=8, fused_decode_steps=2, fused_decode_buckets=(8,)),
    dict(max_batch_size=8, detok_buckets_override=(2, 8)),
    dict(max_batch_size=16, decode_buckets_override=(4, 16)),
])
def test_online_detokenize_batch_cap_matches_jax(interval, kw):
    """The online scheduler sizes its per-round detokenize batch from the
    worker's lattice: the port's must equal the JAX package's (at max
    batch 4, interval 10: 1 row; 2 under fused buckets 1,4 with k=4)."""
    tm, jm = _interval_dummies(interval)
    cfg = dict(num_pages=64, page_size=8, prefill_token_buckets=(64,), **kw)
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    B = kw["max_batch_size"]
    ts = load_scheduler("online", model_worker=tw, max_batch_size=B,
                        connect=False)
    js = JOnline(model_worker=jw, max_batch_size=B, connect=False)
    assert ts.detokenize_max_batch_size == js.detokenize_max_batch_size
    if interval == 10 and B == 4:
        assert ts.detokenize_max_batch_size == (
            2 if kw.get("fused_decode_steps") else 1)


# -- pipelined readback ----------------------------------------------------


def _rounds(w, n_req=3, rounds=3, check=None):
    """Detokenize n_req streams window by window over `rounds` calls (one
    stream skips the middle call); returns each stream's PCM bytes."""
    interval = w.detokenize_interval
    reqs = [_req_with_audio(w, f"p{i}", rounds * interval, seed=i)
            for i in range(n_req)]
    for k in range(rounds):
        sel = [r for i, r in enumerate(reqs) if not (k == 1 and i == 0)]
        for r in sel:
            r.next_audio_decode_idx = [k * interval]
        w.run_detokenize(sel)
        if check:
            check(w)
    reqs[0].next_audio_decode_idx = [interval]
    w.run_detokenize([reqs[0]])
    w.flush_detokenize()
    assert not w._pending_detok
    return [_drain_pcm(r) for r in reqs]


@pytest.mark.parametrize("pipeline,detok_depth,effective", [
    (0, 2, 0), (1, 0, 1), (1, 1, 1), (2, 2, 2)])
def test_detok_pipelining_matches_synchronous(pipeline, detok_depth,
                                              effective):
    sync = _rounds(_worker())
    w = _worker(pipeline_depth=pipeline, detok_pipeline_depth=detok_depth)
    jw = JWorker(JDummyLM(), JWorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), warmup=False,
        pipeline_depth=pipeline, detok_pipeline_depth=detok_depth))
    assert w._detok_depth == jw._detok_depth == effective

    def check(w):
        assert len(w._pending_detok) <= effective

    piped = _rounds(w, check=check)
    # the deepest the queue got: the batch just issued on top of the
    # `effective` deferred ones
    assert w.max_pending_detok == effective + 1
    assert piped == sync
    assert all(len(p) == 3 * 4 * S * 2 for p in piped)


def test_detok_pipelining_through_the_online_scheduler_qwen3():
    """Debug Qwen3 served by the online scheduler with decode and
    detokenize two deep against synchronous: the same greedy tokens, the
    same number of samples, PCM within 4 int16 steps. (On the CPU every
    batch is done when it is polled, so the queue's depth is the worker
    tests' to show.)"""
    def serve(**kw):
        m = debug_qwen3()
        m.sampling_config = m.sampling_config.replace(greedy=True,
                                                      max_tokens=40)
        w = ModelWorker(m, WorkerConfig(
            max_batch_size=4, num_pages=600, page_size=8,
            prefill_token_buckets=(128,), max_prefill_requests=4, **kw))
        s = load_scheduler("online", model_worker=w, max_batch_size=4,
                           connect=False)
        reqs = [Request(request_id=f"s{i}", prompt=f"stream {i}",
                        is_streaming=True, is_pressing=True)
                for i in range(3)]
        for r in reqs:
            s.enqueue_request(r)
        for _ in range(300):
            s._step()
            if all(r.done_all for r in reqs):
                break
        out = []
        for r in reqs:
            assert r.done_all
            pcm = b"".join(m_.split(b"|", 2)[2] for m_ in s._inproc_results
                           if m_.startswith(r.request_id.encode() + b"|")
                           and m_.split(b"|")[1] == b"AUDIO")
            out.append(([tuple(t) for t in r.lm_output_tokens], pcm))
        assert not w._pending_detok and not w._pending
        return out, w

    sync, _ = serve()
    piped, w = serve(pipeline_depth=2, detok_pipeline_depth=2)
    assert w._detok_depth == 2
    for (ta, a), (tb, b) in zip(piped, sync):
        assert ta == tb
        assert len(a) == len(b) and a
        diff = np.abs(np.frombuffer(a, np.int16).astype(np.int32)
                      - np.frombuffer(b, np.int16))
        assert diff.max() <= 4


# -- multi-chunk windows (tests/test_multi_chunk_detok.py's oracle) -------


def _jworker(**kw):
    return JWorker(JDummyLM(max_tokens=64), JWorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=4, warmup=False,
        **kw))


def test_k_windows_consumed_in_one_step():
    interval = 4
    pcms = []
    for w, cls in ((_worker(), Request), (_jworker(), JRequest)):
        req = _req_with_audio(w, "mc", 5 * interval, cls=cls)
        req.next_audio_decode_idx = [i * interval for i in range(5)]
        w.run_detokenize([req])
        w.flush_detokenize()
        # multi_chunk_ks=(4, 2): 4 of the 5 windows consumed at once
        assert req.audio_decode_idx == [0, interval, 2 * interval,
                                        3 * interval]
        pcms.append(np.frombuffer(_drain_pcm(req), np.int16))
        assert len(pcms[-1]) == 4 * interval * S
    np.testing.assert_allclose(pcms[0], pcms[1], atol=2)


def test_multi_chunk_matches_sequential_decode():
    """One k=4 window gives the audio of 4 sequential windows (the codec
    cache advances identically)."""
    interval = 4
    w1 = _worker()
    r1 = _req_with_audio(w1, "a", 4 * interval)
    r1.next_audio_decode_idx = [i * interval for i in range(4)]
    w1.run_detokenize([r1])
    w1.flush_detokenize()
    combined = np.frombuffer(_drain_pcm(r1), np.int16)

    w2 = _worker(multi_chunk_ks=())
    r2 = _req_with_audio(w2, "b", 4 * interval)
    seq = b""
    for i in range(4):
        r2.next_audio_decode_idx = [i * interval]
        w2.run_detokenize([r2])
        w2.flush_detokenize()
        seq += _drain_pcm(r2)
    sequential = np.frombuffer(seq, np.int16)
    assert combined.shape == sequential.shape
    np.testing.assert_allclose(combined, sequential, atol=2)


def test_partial_final_window_in_combined_batch():
    interval = 4
    n = 2 * interval + 2
    lens = []
    for w, cls in ((_worker(), Request), (_jworker(), JRequest)):
        req = _req_with_audio(w, "p", n, cls=cls)
        req.done_lm_generation = True
        req.finish_reason = "stop"
        req.next_audio_decode_idx = [0, interval, 2 * interval]
        w.run_detokenize([req])
        w.flush_detokenize()
        assert req.audio_decode_idx == [0, interval]
        first = len(_drain_pcm(req))
        req.next_audio_decode_idx = [2 * interval]
        w.run_detokenize([req])
        w.flush_detokenize()
        second = len(_drain_pcm(req))
        assert req.done_all
        lens.append((first, second))
    assert lens[0] == lens[1] == (
        2 * interval * S * 2, 2 * int(interval * S * 1.5 / interval))


def test_detok_frame_budget_splits_wide_batches():
    """Above the frame budget a batch splits across the widest in-budget
    bucket (2 calls for 3 windows at cap 2), as in the JAX worker."""
    interval = 4
    counts = []
    for w, cls in ((_worker(detok_buckets_override=(2, 4),
                            detok_frame_budget=8), Request),
                   (_jworker(detok_buckets_override=(2, 4),
                             detok_frame_budget=8), JRequest)):
        assert w._detok_cap(interval) == 2
        assert w._detok_cap(4 * interval) == 2
        assert w._detok_bucket(3, interval) == 2
        reqs = []
        for i in range(3):
            r = _req_with_audio(w, f"b{i}", interval, cls=cls)
            r.next_audio_decode_idx = [0]
            reqs.append(r)
        w.run_detokenize(reqs)
        w.flush_detokenize()
        counts.append(w.phase_stats["detok.windows"])
        for r in reqs:
            assert len(_drain_pcm(r)) == interval * S * 2
    assert counts[0] == counts[1] == (3, 2)


# -- flush and poll ----------------------------------------------------------


def test_flush_and_poll_resolve_pending_batches():
    w = _worker(pipeline_depth=2, detok_pipeline_depth=2)
    interval = w.detokenize_interval
    reqs = [_req_with_audio(w, f"f{i}", 2 * interval, seed=i)
            for i in range(3)]
    for r in reqs[:2]:
        r.next_audio_decode_idx = [0]
        assert w.run_detokenize([r]) == []  # deferred: nothing resolved
    assert len(w._pending_detok) == 2
    # the next batch displaces the oldest: its stream resolves
    reqs[2].next_audio_decode_idx = [0]
    assert w.run_detokenize([reqs[2]]) == [reqs[0]]
    # a round with nothing to issue resolves one pending batch
    assert w.run_detokenize([]) == [reqs[1]]
    # poll_resolved returns the streams whose audio resolved (all done on
    # the CPU)
    assert w.poll_resolved() == [reqs[2]]
    assert not w._pending_detok
    for r in reqs:
        assert len(_drain_pcm(r)) == interval * S * 2
        r.next_audio_decode_idx = [interval]
    w.run_detokenize(reqs[:2])
    w.run_detokenize(reqs[2:])
    assert w.flush_detokenize() == reqs
    assert not w._pending_detok
    for r in reqs:
        assert len(_drain_pcm(r)) == interval * S * 2


@pytest.mark.parametrize("detok_depth", [1, 2])
@pytest.mark.parametrize("last", [2, 4])
@pytest.mark.parametrize("other", [False, True])
def test_window_in_flight_holds_the_completion(detok_depth, last, other):
    """A stream whose last window is still in a detokenize batch in flight
    is not finished, and goes back to the scheduler done only with that
    audio: neither the batch before it resolving finishes it (the JAX
    worker's ``_maybe_finish`` there reads the window list the later
    dispatch has already advanced), nor does the scheduler's own mark (the
    online scheduler marks a stream done once its last window is selected,
    then sends its completion with its next audio or at its next round)
    hand it back before its last window resolves, also when (``other``)
    another stream's batch sits between and another stream's window
    dispatches beside it."""
    w = _worker(pipeline_depth=2, detok_pipeline_depth=detok_depth)
    interval = w.detokenize_interval
    req = _req_with_audio(w, "t", 2 * interval + last)
    req.done_lm_generation = True
    pcm, returned = b"", []

    def window(r, start):
        r.next_audio_decode_idx = [start]
        return w.run_detokenize([r])

    for start in (0, interval):
        returned += window(req, start)
    if other:
        window(_req_with_audio(w, "c", interval, seed=9), 0)
    returned += window(req, 2 * interval)
    pcm += _drain_pcm(req)
    assert not req.done_all  # its last window is in flight
    req.done_all, req.next_audio_decode_idx = True, []
    batch = [req]
    if other:
        batch.append(_req_with_audio(w, "o", interval, seed=8))
        batch[1].next_audio_decode_idx = [0]
    returned += w.run_detokenize(batch)
    assert req in returned and not w._in_flight(req)
    pcm += _drain_pcm(req)
    tail = last * S if last == interval else int(
        interval * S * (last - 0.5) / interval)
    assert len(pcm) == 2 * (2 * interval * S + tail)


# -- slot codec rows -----------------------------------------------------------


def test_codec_cache_has_a_sentinel_row():
    w = _worker(debug_qwen3())
    for leaf in tree_leaves(w.codec_cache):
        assert leaf.shape[0] == w.config.max_batch_size + 1


def test_padded_rows_leave_other_slots_codec_rows_untouched():
    """Three windows in a bucket of 4 (one padded row on the sentinel
    slot): the three slots' rows advance as one-row detokenizes would, and
    the fourth slot's row does not move."""
    w = _worker(debug_qwen3())
    reqs = [_req_with_audio(w, f"q{i}", 4, seed=i) for i in range(4)]
    g = torch.Generator().manual_seed(0)
    for leaf in tree_leaves(w.codec_cache):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    saved = [t.clone() for t in tree_leaves(w.codec_cache)]
    sel = [reqs[0], reqs[2], reqs[3]]
    for r in sel:
        r.next_audio_decode_idx = [0]
    w.run_detokenize(sel)
    assert w._detok_bucket(3, 4) == 4
    batched = [_drain_pcm(r) for r in sel]
    after = [t.clone() for t in tree_leaves(w.codec_cache)]
    for a, s in zip(after, saved):
        assert torch.equal(a[1], s[1])  # slot 1: not in the batch
    moved = [i for i in (0, 2, 3)
             if any(not torch.equal(a[i], s[i])
                    for a, s in zip(after, saved))]
    assert moved == [0, 2, 3]
    # each row alone from the same state
    for t, s in zip(tree_leaves(w.codec_cache), saved):
        t.copy_(s)
    for r, pcm in zip(sel, batched):
        r.next_audio_decode_idx = [0]
        w.run_detokenize([r])
        alone = _drain_pcm(r)
        assert len(alone) == len(pcm)
        diff = np.abs(np.frombuffer(alone, np.int16).astype(np.int32)
                      - np.frombuffer(pcm, np.int16))
        assert diff.max() <= 4
    for a, b in zip(after, tree_leaves(w.codec_cache)):
        torch.testing.assert_close(a[:4], b[:4], atol=1e-5, rtol=1e-5)


class _InitRowDummy(DummyLM):
    """A dummy whose preprocess gives each request its own codec phase."""

    def preprocess(self, prompt=None, audio_path=None, **kw):
        po = super().preprocess(prompt, audio_path, **kw)
        po.decoder_cache_init = {"phase": np.float32(0.25 * len(prompt))}
        return po


class _JInitRowDummy(JDummyLM):
    def preprocess(self, prompt=None, audio_path=None, **kw):
        po = super().preprocess(prompt, audio_path, **kw)
        po.decoder_cache_init = {"phase": np.float32(0.25 * len(prompt))}
        return po


def test_admission_writes_decoder_cache_init():
    """A model's own initial codec row lands in the request's slot on
    admission (and a reused slot is zeroed first), as in the JAX worker."""
    tw = _worker(_InitRowDummy())
    jw = JWorker(_JInitRowDummy(), JWorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=4, warmup=False))
    prompts = ("abc", "hello!")
    treqs = [Request(request_id=f"t{i}", prompt=p)
             for i, p in enumerate(prompts)]
    jreqs = [JRequest(request_id=f"j{i}", prompt=p)
             for i, p in enumerate(prompts)]
    tw.run_lm_prefill(treqs)
    jw.run_lm_prefill(jreqs)
    tw.sync()
    jw.sync()
    assert [r.slot for r in treqs] == [r.slot for r in jreqs]
    got = tw.codec_cache["phase"].numpy()
    want = np.asarray(jw.codec_cache["phase"])
    np.testing.assert_array_equal(got[:4], want[:4])
    for r, p in zip(treqs, prompts):
        assert got[r.slot] == np.float32(0.25 * len(p))


def test_graph_counters_carry_every_kernel_counter():
    """A captured graph records what its capture added to every kernel
    counter, K2's whole-stack count beside the launches, and adds it back
    on each replay (the card test holds a real detokenize graph to it)."""
    from vox_serve_tpu_torch.ops import kernels
    from vox_serve_tpu_torch.worker import graphs

    k2 = kernels.wrappers()["fused_resunit_stack"]
    before = kernels.counters()
    assert ("fused_resunit_stack", "stacks") in before
    k2.stacks += 2  # what a capture of two stacks of nine launches counts
    k2.launches += 18
    counts = graphs.increments(before, kernels.counters())
    assert sorted((fn.__name__, field, n) for fn, field, n in counts) == [
        ("fused_resunit_stack", "launches", 18),
        ("fused_resunit_stack", "stacks", 2)]
    kernels.set_counters(before)  # the capture itself counts nothing
    assert kernels.counters() == before
    for _ in range(3):
        graphs.add_counts(counts)
    assert k2.stacks == before["fused_resunit_stack", "stacks"] + 6
    assert k2.launches == before["fused_resunit_stack", "launches"] + 54
    kernels.set_counters(before)


def test_completed_stream_reselected_plans_no_window():
    """The online scheduler's second detokenize selection of a round (the
    light-load branch) can re-select a stream it completed earlier in that
    round: its slot is freed and its last window still named. The worker
    plans no window for a done stream (planning one decoded that window
    again, from no slot, and failed the batch and every stream in it)."""
    w = _worker()
    interval = w.detokenize_interval
    done = Request(request_id="done")
    w.admit(done)
    done.lm_output_audio_tokens = [np.zeros((1,), np.int32)] * interval
    done.done_lm_generation = True
    done.next_audio_decode_idx = [0]
    w.run_detokenize([done])
    w.flush_detokenize()
    assert done.done_all
    first = _drain_pcm(done)
    assert len(first) > 0
    w.free_kv_cache(done)  # the scheduler's completion frees the slot
    assert done.slot is None
    live = Request(request_id="live")
    w.admit(live)
    live.lm_output_audio_tokens = [np.ones((1,), np.int32)] * interval
    live.next_audio_decode_idx = [0]
    touched = w.run_detokenize([done, live])
    touched += w.flush_detokenize()
    assert done in touched and live in touched
    assert _drain_pcm(done) == b"" and len(_drain_pcm(live)) == len(first)
    assert done.finish_reason is None and not live.done_all
