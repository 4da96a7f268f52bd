"""Port parity, streamed text input on the CPU: the worker's injection of
streamed text (``_inject_streaming_text_token``) and the override planes
of the single-step and fused packs against the JAX worker's, a deferred or
hard-stopped row that consumes no text, the fused k capped by queued text,
the ``input_streaming`` scheduler's session life cycle, the ``offline``
scheduler's detokenize selection and serving, greedy tokens of streamed
requests against the JAX package's, and one HTTP round trip of the
text-stream protocol through ``python -m vox_serve_tpu_torch.launch``.

Tolerances: packs, tokens and request states exact; the dummy codec's PCM
within 2 int16 steps of the JAX package's (a float32 phase cumsum in
another order), the debug Qwen3 codec's within 4.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_scheduler import FakeWorker
from test_torch_first_chunk import _greedy_dummies
from test_torch_fused_decode import _qwen3_pair
from test_torch_worker_decode import SPECS, _pair_workers, _twin_requests
from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.scheduler.input_streaming import (
    InputStreamingScheduler as JInputStreaming)
from vox_serve_tpu.scheduler.offline import OfflineScheduler as JOffline
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import (SCHEDULER_REGISTRY, Scheduler,
                                           load_scheduler)
from vox_serve_tpu_torch.scheduler.input_streaming import (
    MIN_INITIAL_TEXT_CHARS, InputStreamingScheduler)
from vox_serve_tpu_torch.scheduler.offline import OfflineScheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = types.SimpleNamespace(Request=Request, Worker=ModelWorker,
                             Config=WorkerConfig, Dummy=DummyLM,
                             Streaming=InputStreamingScheduler,
                             Offline=OfflineScheduler, Base=Scheduler)
JAX = types.SimpleNamespace(Request=JRequest, Worker=JWorker,
                            Config=lambda **kw: JWorkerConfig(warmup=False,
                                                              **kw),
                            Dummy=JDummyLM, Streaming=JInputStreaming,
                            Offline=JOffline, Base=JScheduler)


def test_registry_and_flags_offer_the_new_schedulers():
    from vox_serve_tpu_torch.launch import build_parser as launch_parser
    from vox_serve_tpu_torch.scheduler_entry import build_parser

    assert set(SCHEDULER_REGISTRY) == {"base", "online", "offline",
                                       "input_streaming", "disaggregation"}
    for parser in (launch_parser(), build_parser()):
        action = next(a for a in parser._actions
                      if a.dest == "scheduler_type")
        assert set(action.choices) == set(SCHEDULER_REGISTRY)


@pytest.mark.parametrize("on", [False, True])
def test_enable_profiling_ranges(on):
    """--enable-profiling: a span in the worker's recorder around each
    step dispatch, named as the JAX worker's trace annotations, and no
    profiler range; no recorder when off."""
    w = ModelWorker(DummyLM(max_tokens=40), WorkerConfig(
        max_batch_size=2, num_pages=32, page_size=8,
        prefill_token_buckets=(64,), enable_profiling=on))
    req = Request(request_id="p", prompt="profiled")
    with torch.profiler.profile() as prof:
        w.run_lm_prefill([req])
        w.run_lm_decode([req])
        w.sync()
    ranges = {"lm_prefill_t64_b1", "lm_decode_b1"}
    assert not ranges & {e.name for e in prof.events()}
    assert (w.spans is not None) == on
    if on:
        spans = list(w.spans.spans)
        assert ranges <= {s.name for s in spans}
        assert all(s.start_ns <= s.end_ns and s.parent is None
                   for s in spans)


def test_cfg_scale_is_overlaid_on_the_sampling_defaults():
    from vox_serve_tpu_torch.models import load_model

    m = load_model("dummy", device="cpu", cfg_scale=1.5)
    assert m.sampling_config.cfg_scale == 1.5
    assert load_model("dummy", device="cpu").sampling_config.cfg_scale \
        is None


# ---------------------------------------------------------------------------
# injection
# ---------------------------------------------------------------------------

def _inject_sequence(worker_cls, model, req_cls):
    """Nine injections into one request: three queued tokens, pad while
    waiting for text, one more token, then text complete: EOS once, then
    pad. Returns each call's token row and the request's flags after it."""
    host = types.SimpleNamespace(model=model)
    req = req_cls(request_id="s", is_input_streaming=True)
    for t in (11, 12, 13):
        req.pending_text_tokens.put(t)
    out = []
    for step in range(9):
        if step == 4:
            req.pending_text_tokens.put(14)
        if step == 6:
            req.text_complete = True
        tok = np.zeros((model.n_codebooks,), np.int32)
        worker_cls._inject_streaming_text_token(host, req, tok)
        out.append((tok.tolist(), req.waiting_for_text, req.eos_injected,
                    req.pending_text_tokens.qsize()))
    return out


@pytest.mark.parametrize("name", ["dummy", "qwen3"])
def test_inject_streaming_text_token_matches_jax(name):
    if name == "dummy":
        tm, jm = DummyLM(), JDummyLM()
    else:
        jm, tm = _qwen3_pair(max_tokens=40)
    got = _inject_sequence(ModelWorker, tm, Request)
    want = _inject_sequence(JWorker, jm, JRequest)
    assert got == want
    ch = tm.text_channel_index
    texts = [row[0][ch] for row in got]
    assert texts[:3] == [11, 12, 13]
    assert texts[3] == tm.text_stream_pad_token() and got[3][1]
    assert texts[4] == 14
    assert texts[6] == tm.text_stream_eos_token()
    assert texts.count(tm.text_stream_eos_token()) == 1
    assert texts[7:] == [tm.text_stream_pad_token()] * 2


def _stream(reqs, queued, complete):
    """Make requests input-streaming with the given queued text tokens."""
    for r, toks, done in zip(reqs, queued, complete):
        if toks is None:
            continue
        r.is_input_streaming = True
        r.text_complete = done
        for t in toks:
            r.pending_text_tokens.put(t)


def _text_state(reqs):
    return [(r.pending_text_tokens.qsize(), r.eos_injected,
             r.waiting_for_text) for r in reqs]


# streamed rows: 2 tokens + complete (EOS inside a fused window), 5 tokens
# still open, none (a plain row), and one at the block-table limit
QUEUED = [[21, 22], [31, 32, 33, 34, 35], None, [41, 42]]
COMPLETE = [True, False, False, False]


def test_single_step_override_planes_match_jax():
    tw, jw = _pair_workers(max_batch_size=4, num_pages=64, page_size=8)
    limit = tw.max_pages_per_seq * 8
    specs = SPECS + [(3, limit, 20, 0, 0)]
    treqs, jreqs = _twin_requests(tw, jw, specs)
    _stream(treqs, QUEUED, COMPLETE)
    _stream(jreqs, QUEUED, COMPLETE)
    seen = {}

    def fake_get(phase, bucket):
        def fn(params, packed, k, v, rep, fb, last, key, counter):
            seen["pack"] = np.asarray(packed)
            return (jnp.zeros((packed.shape[0], 1), jnp.int32), k, v, rep,
                    fb, last)
        return fn

    jw._get_lm_fn = fake_get
    B = tw._decode_bucket(len(treqs))
    pack, hard = tw._plan_decode(treqs, B, tw._table_width(treqs))
    jw.run_lm_decode(jreqs)
    np.testing.assert_array_equal(pack, seen["pack"])
    assert hard == {3}
    C = 1
    assert pack[:3, 0].tolist() == [21, 31, 0]  # the override column
    assert pack[:3, C].tolist() == [1, 1, 0]    # its mask
    assert pack[3, :2 * C].tolist() == [0, 0]   # the hard-stopped row
    # the hard-stopped row consumed nothing
    assert _text_state(treqs) == _text_state(jreqs)
    assert treqs[3].pending_text_tokens.qsize() == 2


@pytest.mark.parametrize("K", [2, 4])
def test_fused_override_planes_match_jax(K):
    tw, jw = _pair_workers(max_batch_size=4, num_pages=64, page_size=8,
                           fused_decode_steps=4, fused_decode_buckets=(4,))
    treqs, jreqs = _twin_requests(tw, jw, SPECS)
    _stream(treqs, QUEUED[:3], COMPLETE[:3])
    _stream(jreqs, QUEUED[:3], COMPLETE[:3])
    pack, hard = tw._plan_decode_multi(treqs, K, 4)
    jarr, jhard = jw._plan_decode_multi(jreqs, K, 4)
    np.testing.assert_array_equal(pack, jarr["pack"])
    assert hard == jhard == set()
    assert _text_state(treqs) == _text_state(jreqs)
    planes = pack[:2 * K * 4].reshape(2, K, 4)  # (overrides, mask), C = 1
    stop = DummyLM.STOP_TOKEN
    assert planes[0, :, 0].tolist() == [21, 22, stop, 0][:K]
    assert planes[0, :, 1].tolist() == [31, 32, 33, 34][:K]
    assert planes[1, :, :2].all() and not planes[1, :, 2:].any()


# ---------------------------------------------------------------------------
# rows that do not step consume no text
# ---------------------------------------------------------------------------

def _plan_arrays(worker, B, C):
    return (np.zeros((B, C), np.int32), np.zeros((B, C), np.int32),
            np.zeros((B,), np.int32), np.zeros((B,), np.int32),
            np.zeros((B,), np.int32), np.zeros((B,), np.int32),
            np.zeros((B, worker.max_pages_per_seq), np.int32),
            np.ones((B,), np.int32), np.zeros((B,), np.int32))


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_deferred_row_does_not_consume_streamed_text(pkg):
    """tests/test_kv_pressure.py's oracle, on both workers: a row deferred
    by KV backpressure keeps its queued text token and the one-shot EOS,
    and takes them at the step it does run. Nothing is reserved at
    admission (kv_reserve_fraction 0), so an empty pool defers the row."""
    model = pkg.Dummy(max_tokens=40)
    worker = pkg.Worker(model, pkg.Config(
        max_batch_size=2, num_pages=16, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=2,
        kv_reserve_fraction=0.0))
    req = pkg.Request(request_id="st", prompt="hello world",
                      is_input_streaming=True, is_streaming=True)
    worker.run_lm_prefill([req])
    worker.sync()
    assert not req.done_lm_generation and req.kv_pages
    assert not req.extras.get("kv_reserved")
    req.pending_text_tokens.put(7)
    req.pending_text_tokens.put(8)
    hold = worker.allocator.alloc(worker.allocator.num_unreserved)
    req.kv_token_len = len(req.kv_pages) * 8  # its next token needs a page
    before = req.pending_text_tokens.qsize()
    arrays = _plan_arrays(worker, 2, model.n_codebooks)
    hard = set()
    worker._plan_decode_row(req, 0, *arrays, hard)
    assert 0 in hard
    assert req.pending_text_tokens.qsize() == before
    assert not req.eos_injected
    while not req.pending_text_tokens.empty():
        req.pending_text_tokens.get()
    req.text_complete = True
    hard.clear()
    worker._plan_decode_row(req, 0, *arrays, hard)
    assert 0 in hard and not req.eos_injected
    worker.allocator.free(hold)
    # with a page free the row steps and takes the EOS, once
    hard.clear()
    worker._plan_decode_row(req, 0, *arrays, hard)
    assert not hard and req.eos_injected
    assert arrays[0][0, 0] == model.text_stream_eos_token()


def test_fused_deferred_row_does_not_consume_streamed_text():
    """The fused plan allocates a row's pages before it injects: a row
    deferred there consumes none of its k tokens."""
    tw, jw = _pair_workers(max_batch_size=4, num_pages=16, page_size=8,
                           fused_decode_steps=4, fused_decode_buckets=(4,))
    for w, cls in ((tw, Request), (jw, JRequest)):
        r = cls(request_id="d")
        r.slot, r.input_length, r.kv_token_len = 0, 8, 8
        r.kv_pages = w.allocator.alloc(1)
        r.lm_output_tokens = [np.zeros((1,), np.int32)]
        _stream([r], [[5, 6, 7, 8]], [True])
        hold = w.allocator.alloc(w.allocator.num_unreserved)
        if w is tw:
            pack, hard = w._plan_decode_multi([r], 4, 4)
        else:
            arr, hard = w._plan_decode_multi([r], 4, 4)
            pack = arr["pack"]
        assert hard == {0}
        assert r.pending_text_tokens.qsize() == 4 and not r.eos_injected
        assert not pack[:2 * 4 * 4].any()
        w.allocator.free(hold)


def test_failed_injection_leaves_a_padded_row(monkeypatch):
    """Injection that raises resets the live row to the padded-slot
    convention before the request is failed and its pages freed."""
    w = ModelWorker(DummyLM(max_tokens=40), WorkerConfig(
        max_batch_size=2, num_pages=32, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=2))
    reqs = [Request(request_id=f"f{i}", prompt="streamed text",
                    is_input_streaming=True) for i in range(2)]
    w.run_lm_prefill(reqs)
    w.sync()
    for r in reqs:
        r.pending_text_tokens.put(9)
    real = ModelWorker._inject_streaming_text_token

    def boom(self, req, tok):
        if req is reqs[0]:
            raise RuntimeError("bad text")
        return real(self, req, tok)

    monkeypatch.setattr(ModelWorker, "_inject_streaming_text_token", boom)
    pack, hard = w._plan_decode(reqs, 2, w._table_width(reqs))
    (ov, mask, gen, pos, pages, offs, _seq, slots,
     _bt) = w._decode_pack_views(pack, 1)
    assert hard == {0}
    assert reqs[0].finish_reason.startswith("error")
    assert slots[0] == 2 and pages[0] == 0 and offs[0] == 0
    assert not mask[0].any()
    assert mask[1, 0] == 1 and ov[1, 0] == 9
    assert not reqs[0].kv_pages and reqs[0].slot is None


def test_fused_k_capped_by_queued_text():
    """tests/test_fused_decode.py's cap, on the port's scheduler: fewer
    queued tokens than k run single steps until the text is complete."""
    w = ModelWorker(DummyLM(max_tokens=40), WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=2,
        fused_decode_steps=4, fused_decode_buckets=(2,)))
    s = Scheduler(model_worker=w, max_batch_size=2, connect=False)
    req = Request(request_id="st", prompt="x", is_input_streaming=True)
    req.pending_text_tokens.put(5)
    req.pending_text_tokens.put(6)
    assert s._fused_decode_steps([req]) == 1
    req.pending_text_tokens.put(7)
    req.pending_text_tokens.put(8)
    assert s._fused_decode_steps([req]) == 4
    while not req.pending_text_tokens.empty():
        req.pending_text_tokens.get()
    req.text_complete = True
    assert s._fused_decode_steps([req]) == 4


# ---------------------------------------------------------------------------
# the input_streaming scheduler
# ---------------------------------------------------------------------------

def _streaming(pkg, max_tokens=40, **kw):
    cfg = dict(max_batch_size=2, num_pages=64, page_size=8,
               prefill_token_buckets=(64,), max_prefill_requests=2)
    cfg.update(kw)
    worker = pkg.Worker(pkg.Dummy(max_tokens=max_tokens), pkg.Config(**cfg))
    return pkg.Streaming(model_worker=worker, max_batch_size=2,
                         connect=False)


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_input_streaming_session_life_cycle(pkg):
    """tests/test_e2e_inprocess.py's session, on both packages: buffer
    below 20 characters, a one-token prefill once past it, a pause while
    the queue is empty, then TEXT_COMPLETE: EOS once and completion."""
    s = _streaming(pkg)
    rid = "stream1"
    s._handle_message(rid.encode() + b"|TEXT_STREAM_START|{}")
    req = s._streams[rid]
    s._handle_message(rid.encode() + b"|TEXT_UPDATE|short text")
    assert len(req.input_text_buffer) < MIN_INITIAL_TEXT_CHARS
    s._step()
    assert not req.done_lm_prefill and not req.prefill_ready
    s._handle_message(rid.encode() + b"|TEXT_UPDATE| and now much longer")
    assert req.prefill_ready and req.input_length == 1
    assert req.input_text_buffer == ""
    queued = req.pending_text_tokens.qsize()
    assert queued == len("short text and now much longer") - 1
    for _ in range(6):
        s._step()
    assert req.done_lm_prefill
    for _ in range(40):
        s._step()
        if req.pending_text_tokens.empty():
            break
    paused = req.num_generated
    s._step()
    s._step()
    assert req.waiting_for_text
    assert req.num_generated <= paused + 1
    s._handle_message(rid.encode() + b"|TEXT_COMPLETE|")
    for _ in range(60):
        s._step()
        if req.done_all:
            break
    assert req.done_all and req.eos_injected
    assert rid not in s._streams
    comps = [m for m in s._inproc_results
             if m.startswith(rid.encode()) and m.split(b"|")[1]
             == b"COMPLETION"]
    assert len(comps) == 1


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_empty_input_stream_completes(pkg):
    s = _streaming(pkg, max_tokens=12)
    s._handle_message(b"er1|TEXT_STREAM_START|{}")
    s._handle_message(b"er1|TEXT_COMPLETE|")
    comps = [m for m in s._inproc_results
             if m.split(b"|")[1] == b"COMPLETION"]
    assert len(comps) == 1
    assert json.loads(comps[0].split(b"|", 2)[2])["reason"] == "empty_stream"
    assert not s.active_requests and "er1" not in s._streams


def test_unknown_text_update_is_ignored():
    s = _streaming(PORT)
    s._handle_message(b"nope|TEXT_UPDATE|some text")
    s._handle_message(b"nope|TEXT_COMPLETE|")
    assert not s.active_requests and not s._inproc_results


# ---------------------------------------------------------------------------
# streamed requests: greedy tokens and audio against the JAX package
# ---------------------------------------------------------------------------

PIECES = ("streamed text arrives", " in pieces, ", "the end.")


def _serve_stream(sched, rid="tx"):
    """The text-stream protocol on a fixed step schedule: start, a piece,
    three steps, a piece, four steps, the last piece, two steps, end."""
    sched._handle_message(rid.encode() + b"|TEXT_STREAM_START|{}")
    for piece, steps in zip(PIECES, (3, 4, 2)):
        sched._handle_message(rid.encode() + b"|TEXT_UPDATE|"
                              + piece.encode())
        for _ in range(steps):
            sched._step()
    req = sched._streams[rid]
    sched._handle_message(rid.encode() + b"|TEXT_COMPLETE|")
    for _ in range(300):
        sched._step()
        if req.done_all:
            break
    assert req.done_all
    pcm = b"".join(m.split(b"|", 2)[2] for m in sched._inproc_results
                   if m.startswith(rid.encode() + b"|")
                   and m.split(b"|")[1] == b"AUDIO")
    return req, np.frombuffer(pcm, np.int16)


@pytest.mark.parametrize("name,kw", [
    ("dummy", {}),
    ("dummy", dict(fused_decode_steps=4, fused_decode_buckets=(2,),
                   pipeline_depth=2)),
    ("qwen3", {}),
])
def test_streamed_request_matches_jax(name, kw):
    if name == "dummy":
        tm, jm = _greedy_dummies(max_tokens=64)
        cfg = dict(num_pages=64, page_size=8, prefill_token_buckets=(64,))
        tol = 2
    else:
        jm, tm = _qwen3_pair(max_tokens=64)
        cfg = dict(num_pages=1200, page_size=8, prefill_token_buckets=(128,))
        tol = 4
    cfg.update(max_batch_size=2, max_prefill_requests=2, **kw)
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    treq, tpcm = _serve_stream(load_scheduler(
        "input_streaming", model_worker=tw, max_batch_size=2,
        connect=False))
    jreq, jpcm = _serve_stream(JInputStreaming(model_worker=jw,
                                               max_batch_size=2,
                                               connect=False))
    assert treq.input_length == jreq.input_length
    assert treq.eos_injected and jreq.eos_injected
    assert len(treq.lm_output_tokens) > 4
    np.testing.assert_array_equal(np.stack(treq.lm_output_tokens),
                                  np.stack(jreq.lm_output_tokens))
    assert treq.finish_reason == jreq.finish_reason
    assert tpcm.size == jpcm.size > 0
    assert np.abs(tpcm.astype(np.int32) - jpcm).max() <= tol


# ---------------------------------------------------------------------------
# the offline scheduler
# ---------------------------------------------------------------------------

def _offline_states(cls):
    """Request states for detokenize selection: (done LM, audio tokens,
    next window index)."""
    states = [(False, 8, None), (True, 8, None), (True, 9, [0, 4]),
              (True, 4, [0]), (True, 13, None), (True, 30, None)]
    out = []
    for i, (done, n, nxt) in enumerate(states):
        r = cls(request_id=f"o{i}", done_lm_prefill=True)
        r.done_lm_generation = done
        r.lm_output_audio_tokens = [np.array([1], np.int32)] * n
        if nxt is not None:
            r.next_audio_decode_idx = list(nxt)
        out.append(r)
    return out


def _selection(sched):
    sel = sched._select_detokenize_requests()
    return ([r.request_id for r in sel],
            [(r.request_id, list(r.next_audio_decode_idx), r.done_all)
             for r in sched.active_requests])


@pytest.mark.parametrize("overlap", [0, 1])
@pytest.mark.parametrize("batch", [2, 4, 16])
@pytest.mark.parametrize("subset", [slice(0, 6), slice(1, 6), slice(2, 4)])
def test_offline_detok_selection_matches_jax(overlap, batch, subset):
    """tests/test_scheduler.py's offline selection, on the same request
    states in both packages: nothing while any request still generates,
    then every available window packed up to max_batch_size."""
    got = []
    for pkg in (PORT, JAX):
        s = pkg.Offline(model_worker=FakeWorker(overlap=overlap),
                        max_batch_size=batch, connect=False)
        s.active_requests = _offline_states(pkg.Request)[subset]
        got.append(_selection(s))
    assert got[0] == got[1]
    if subset.start == 0:
        assert got[0][0] == []  # LM still running: no detokenize


def test_offline_defers_detok_until_lm_done():
    s = OfflineScheduler(model_worker=FakeWorker(), max_batch_size=8,
                         connect=False)
    a = Request(request_id="a", done_lm_prefill=True)
    a.lm_output_audio_tokens = [np.array([1], np.int32)] * 8
    s.active_requests = [a]
    assert s._select_detokenize_requests() == []
    a.done_lm_generation = True
    assert s._select_detokenize_requests() == [a]
    assert a.next_audio_decode_idx == [0, 4]


@pytest.mark.parametrize("budget", [None, 8])
def test_offline_serving_matches_jax(budget):
    """Three requests through the offline scheduler in both packages: the
    same greedy tokens and PCM, every detokenize after the last LM step,
    with the frame budget splitting the windows' batch where it is set."""
    tm, jm = _greedy_dummies(max_tokens=20)
    cfg = dict(max_batch_size=4, num_pages=64, page_size=8,
               prefill_token_buckets=(64,), max_prefill_requests=4,
               detok_buckets_override=(1, 2, 4))
    if budget:
        cfg["detok_frame_budget"] = budget
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    order = []
    real_decode, real_detok = tw.run_lm_decode, tw.run_detokenize

    def decode(reqs):
        order.extend(["lm"] if reqs else [])
        return real_decode(reqs)

    def detok(reqs):
        order.extend(["detok"] if reqs else [])
        return real_detok(reqs)

    tw.run_lm_decode, tw.run_detokenize = decode, detok
    prompts = ("first offline prompt", "second", "and a third one")
    out = []
    for w, sched, cls in ((tw, OfflineScheduler, Request),
                          (jw, JOffline, JRequest)):
        s = sched(model_worker=w, max_batch_size=4, connect=False)
        reqs = [cls(request_id=f"r{i}", prompt=p)
                for i, p in enumerate(prompts)]
        for r in reqs:
            s.enqueue_request(r)
        for _ in range(300):
            s._step()
            if all(r.done_all for r in reqs):
                break
        assert all(r.done_all for r in reqs)
        pcm = {r.request_id: np.frombuffer(b"".join(
            m.split(b"|", 2)[2] for m in s._inproc_results
            if m.startswith(r.request_id.encode() + b"|")
            and m.split(b"|")[1] == b"AUDIO"), np.int16) for r in reqs}
        out.append((reqs, pcm))
    (treqs, tpcm), (jreqs, jpcm) = out
    for t, j in zip(treqs, jreqs):
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
        x, y = tpcm[t.request_id], jpcm[j.request_id]
        assert x.size == y.size > 0
        assert np.abs(x.astype(np.int32) - y).max() <= 2
    assert "detok" in order
    assert "lm" not in order[order.index("detok"):]


# ---------------------------------------------------------------------------
# HTTP: the text-stream protocol against the port's server
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_text_stream_protocol_over_http(tmp_path):
    """tests/test_http_server.py's text-stream round trip against the
    port's server (input_streaming scheduler, bf16 codec, overcommitted KV,
    the async-scheduling, profiling and cfg-scale flags), then a /generate
    request through the same server; the daemon's stats file names the
    codec's tensor dtype and the reserve fraction it served."""
    import httpx

    port = _free_port()
    stats = tmp_path / "stats.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--max-batch-size", "2",
         "--max-num-pages", "64", "--page-size", "8",
         "--prefill-buckets", "64", "--socket-suffix", f"_tis{port}",
         "--scheduler-type", "input_streaming", "--codec-dtype", "bfloat16",
         "--kv-reserve-fraction", "0.5", "--async-scheduling",
         "--enable-profiling", "--cfg-scale", "1.5", "--max-tokens", "40",
         "--stats-file", str(stats)], cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "server died during startup"
            try:
                if httpx.get(base + "/health", timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.time() < deadline, "server did not become healthy"
            time.sleep(0.3)
        r = httpx.post(base + "/generate/stream/start", data={}, timeout=30)
        assert r.status_code == 200
        rid = r.json()["request_id"]
        r = httpx.post(base + f"/generate/stream/{rid}/text",
                       data={"text": "incremental text that is long enough"},
                       timeout=30)
        assert r.status_code == 200 and r.json()["status"] == "accepted"
        chunks = []

        def consume():
            with httpx.stream("GET", base + f"/generate/stream/{rid}/audio",
                              timeout=120) as resp:
                assert resp.status_code == 200
                for b in resp.iter_bytes():
                    chunks.append(b)

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.5)
        r = httpx.post(base + f"/generate/stream/{rid}/text",
                       data={"text": " and a second piece"}, timeout=30)
        assert r.status_code == 200
        r = httpx.post(base + f"/generate/stream/{rid}/end", timeout=30)
        assert r.status_code == 200
        t.join(timeout=120)
        assert not t.is_alive()
        body = b"".join(chunks)
        assert body[:4] == b"RIFF" and len(body) > 44
        with httpx.stream("POST", base + "/generate",
                          data={"text": "a plain request"},
                          timeout=120) as r:
            assert r.status_code == 200
            body = b"".join(r.iter_bytes())
        assert body[:4] == b"RIFF" and len(body) > 44
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    for _ in range(100):
        if stats.exists() and stats.stat().st_size:
            break
        time.sleep(0.1)
    got = json.loads(stats.read_text())
    assert got["codec_dtypes"] == ["bfloat16"]
    assert got["kv_reserve_fraction"] == 0.5
    assert got["async_scheduling"] is True
    assert got["pipeline_depth"] == 2  # --async-scheduling at depth 0
