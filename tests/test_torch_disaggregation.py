"""LM / detokenizer disaggregation in the port
(``vox_serve_tpu_torch/scheduler/disaggregation.py``, the worker's
``detokenizer_device_index`` and dispatch lock, the launcher's guards)
against the JAX package's (``tests/test_disaggregation.py``):

* both schedulers refuse a worker whose detokenizer is on its LM's device
  (the JAX oracle's real worker on its one CPU device, the port's on the
  CPU);
* both schedulers, over one scripted worker double that reports two
  device labels and runs their executor calls inline, pick the same
  prefill, decode and detokenize batches in the same order, hold the same
  ``_detokenizing_ids`` at each detokenize call, flush only when the
  queue is empty and fail a batch whose detokenize raises;
* the port's scheduler with its real executor threads over a CPU dummy
  worker (two device labels) completes every stream;
* the port's dispatch lock: two threads driving decode and detokenize on
  a CPU dummy worker give the serial run's tokens and PCM;
* the launcher: ``--dp-size > 1`` with disaggregation exits 2, and on
  ``--device cuda`` too few cards stop the daemons with a message that
  names the count (the count faked);
* on two cards (marker ``cuda``, skipped with fewer): the split worker's
  codec state and detokenize graphs on ``cuda:1``, its PCM equal to an
  unsplit worker's.
"""

import asyncio
import concurrent.futures
import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import vox_serve_tpu.requests as jreq
import vox_serve_tpu_torch.requests as treq
from vox_serve_tpu.models.dummy import DummyLM as JaxDummy
from vox_serve_tpu.scheduler.disaggregation import (
    DisaggregationScheduler as JaxDisagg)
from vox_serve_tpu.worker import ModelWorker as JaxWorker
from vox_serve_tpu.worker import WorkerConfig as JaxConfig
from vox_serve_tpu_torch import launch
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.scheduler.disaggregation import (
    DisaggregationScheduler as PortDisagg)
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

PACKAGES = {"jax": (JaxDisagg, jreq.Request), "port": (PortDisagg,
                                                      treq.Request)}


def _port_worker(**kw):
    cfg = WorkerConfig(max_batch_size=4, num_pages=64, page_size=8,
                       prefill_token_buckets=(32,), max_prefill_requests=2,
                       warmup=False, **kw)
    return ModelWorker(DummyLM(max_tokens=40, device="cpu"), cfg)


def test_refuses_a_worker_on_one_device():
    jw = JaxWorker(JaxDummy(max_tokens=12), JaxConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(32,), warmup=False))
    with pytest.raises(ValueError):
        JaxDisagg(model_worker=jw, max_batch_size=2, connect=False)
    pw = _port_worker()
    assert pw.detokenizer_device == pw.lm_device
    with pytest.raises(ValueError, match="distinct detokenizer_device"):
        PortDisagg(model_worker=pw, max_batch_size=2, connect=False)
    with pytest.raises(ValueError, match="distinct detokenizer_device"):
        load_scheduler("disaggregation", model_worker=pw, max_batch_size=2,
                       connect=False)


def test_cpu_worker_refuses_a_detokenizer_card():
    with pytest.raises(ValueError, match="CUDA card"):
        _port_worker(detokenizer_device_index=1)


# ---------------------------------------------------------------------------
# both schedulers over one scripted double
# ---------------------------------------------------------------------------
class Inline(concurrent.futures.Executor):
    """Runs each call at submission, in the caller's thread: the two loops
    then interleave only at their awaits, the same way in both
    packages."""

    def submit(self, fn, *args, **kwargs):
        f = concurrent.futures.Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except Exception as e:
            f.set_exception(e)
        return f


class ScriptedWorker:
    """The worker interface the schedulers call, with two device labels:
    request i produces ``LENGTHS[i]`` audio tokens (one a decode step) and
    then stops; a detokenize emits each selected window as bytes, and
    raises for a request whose prompt is ``"boom"``."""

    INTERVAL = 4
    LENGTHS = (9, 4, 13, 6, 8)

    def __init__(self):
        self.model = types.SimpleNamespace(sample_rate=16000, n_channels=1)
        self.lm_device, self.detokenizer_device = "lm", "detok"
        self.config = types.SimpleNamespace(
            max_prefill_requests=2, fused_decode_steps=0,
            fused_decode_buckets=(1,), fused_k_schedule=None,
            fused_min_batch=None)
        self.detokenize_interval = self.INTERVAL
        self.detokenize_overlap = 0
        self.max_prefill_tokens = 64
        self.supports_audio_input = False
        self.first_chunk_frames = 0
        self.ramp_frames = 0
        self.log: list = []
        self.sched = None

    def can_admit(self, n, holds_slot=False):
        return True

    def run_lm_prefill(self, reqs):
        self.log.append(("prefill", [r.request_id for r in reqs]))
        for r in reqs:
            r.done_lm_prefill = True
            r.input_length = len(r.prompt)

    def run_lm_decode(self, reqs):
        self.log.append(("decode", [r.request_id for r in reqs]))
        for r in reqs:
            n = self.LENGTHS[int(r.request_id[1:])]
            if len(r.lm_output_audio_tokens) < n:
                r.lm_output_audio_tokens.append(
                    np.array([len(r.lm_output_audio_tokens)], np.int32))
            if len(r.lm_output_audio_tokens) >= n:
                r.done_lm_generation = True
                r.finish_reason = "stop"

    def run_lm_decode_multi(self, reqs, k):  # pragma: no cover
        raise AssertionError("no fused decode configured")

    def run_detokenize(self, reqs):
        self.log.append(("detokenize", [r.request_id for r in reqs],
                         sorted(self.sched._detokenizing_ids)))
        if any(r.prompt == "boom" for r in reqs):
            raise RuntimeError("codec fault")
        out = []
        for r in reqs:
            for start in r.next_audio_decode_idx:
                toks = r.lm_output_audio_tokens[start:start + self.INTERVAL]
                if toks:
                    r.output_audio.put(bytes(len(toks) * 2))
            r.audio_decode_idx = list(r.next_audio_decode_idx)
            if r.done_lm_generation and (
                    not r.audio_decode_idx or r.audio_decode_idx[-1]
                    + self.INTERVAL >= len(r.lm_output_audio_tokens)):
                r.done_all = True
            out.append(r)
        return out

    def flush_detokenize(self):
        self.log.append(("flush", self.sched._detok_queue.qsize()))
        return []

    def fail_request(self, req, reason):
        req.done_lm_generation = True
        req.done_all = True
        req.finish_reason = f"error: {reason}"

    def free_kv_cache(self, req):
        pass

    def sync(self):
        pass

    def poll_resolved(self):
        return []


def _scripted_run(pkg: str, prompts: list[str]) -> tuple[list, list]:
    cls, Request = PACKAGES[pkg]
    worker = ScriptedWorker()
    sched = cls(model_worker=worker, max_batch_size=3, connect=False)
    worker.sched = sched
    sched._lm_pool = sched._detok_pool = Inline()
    for i, p in enumerate(prompts):
        sched.enqueue_request(Request(request_id=f"r{i}", prompt=p,
                                      is_streaming=True))

    def completions():
        return [m.split(b"|")[0].decode() for m in sched._inproc_results
                if b"|COMPLETION|" in m]

    async def drive():
        task = asyncio.ensure_future(sched._main())
        try:
            while len(completions()) < len(prompts):
                if task.done():
                    task.result()
                await asyncio.sleep(0.001)
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    asyncio.run(asyncio.wait_for(drive(), 30))
    return worker.log, [_untimed(m) for m in sched._inproc_results]


def _untimed(message: bytes) -> bytes:
    """A result message less a completion's wall-clock timing."""
    rid, kind, body = message.split(b"|", 2)
    if kind == b"COMPLETION":
        msg = json.loads(body)
        msg.pop("timing", None)
        body = json.dumps(msg).encode()
    return b"|".join((rid, kind, body))


@pytest.mark.parametrize("prompts", [
    ["one", "two", "three", "four"],
    ["one", "boom", "three", "four", "five"],
], ids=["clean", "failing-detokenize"])
def test_scripted_batches_match_jax(prompts):
    port_log, port_out = _scripted_run("port", prompts)
    jax_log, jax_out = _scripted_run("jax", prompts)
    assert port_log == jax_log
    assert port_out == jax_out
    kinds = [e[0] for e in port_log]
    assert {"prefill", "decode", "detokenize", "flush"} <= set(kinds)
    # a flush only ever finds the queue empty
    assert all(e[1] == 0 for e in port_log if e[0] == "flush")
    # the ids in flight at a detokenize call include its own batch
    for e in port_log:
        if e[0] == "detokenize":
            assert set(e[1]) <= set(e[2])
    completions = [m for m in port_out if b"|COMPLETION|" in m]
    assert len(completions) == len(prompts)
    if "boom" in prompts:
        bad = [m for m in completions if m.startswith(b"r1|")]
        assert b"detokenize: codec fault" in bad[0]


class _TwoLabels:
    """A real worker that reports two device labels (the scheduler's
    check), everything else its own."""

    def __init__(self, worker):
        self._w = worker
        self.lm_device, self.detokenizer_device = "lm", "detok"

    def __getattr__(self, name):
        return getattr(self._w, name)


def test_real_threads_over_a_cpu_worker_complete_every_stream():
    """The port's scheduler with its two executor threads over a real CPU
    dummy worker: every stream completes, with audio, within 30 s."""
    w = _port_worker()
    sched = PortDisagg(model_worker=_TwoLabels(w), max_batch_size=4,
                       connect=False)
    for i in range(4):
        sched.enqueue_request(treq.Request(request_id=f"t{i}",
                                           prompt=f"stream {i}",
                                           is_streaming=True))
    loop = asyncio.new_event_loop()
    main = loop.create_task(sched._main())

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main)
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def sent(kind):
        return [m for m in list(sched._inproc_results) if kind in m]

    try:
        deadline = time.monotonic() + 30
        while (len(sent(b"|COMPLETION|")) < 4
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        loop.call_soon_threadsafe(main.cancel)
        th.join(timeout=10)
        sched._lm_pool.shutdown(wait=False)
        sched._detok_pool.shutdown(wait=False)
    assert not th.is_alive()
    done = sent(b"|COMPLETION|")
    assert len(done) == 4
    assert all(b'"error' not in m for m in done)
    audio = {m.split(b"|")[0] for m in sent(b"|AUDIO|")}
    assert audio == {f"t{i}".encode() for i in range(4)}


# ---------------------------------------------------------------------------
# the dispatch lock
# ---------------------------------------------------------------------------
def _lock_run(threaded: bool):
    """B requests decode in one thread while A requests' windows
    detokenize in another (or both serially): B's tokens, A's PCM."""
    torch.manual_seed(0)
    w = _port_worker()
    reqs = [treq.Request(request_id=f"q{i}", prompt=f"prompt {i}")
            for i in range(4)]
    a, b = reqs[:2], reqs[2:]
    w.run_lm_prefill(a)
    for _ in range(16):
        w.run_lm_decode(a)
    w.run_lm_prefill(b)
    w.sync()
    interval = w.detokenize_interval
    # windows of each request's own tokens (a sampled stop may end one)
    n_windows = max(len(r.lm_output_audio_tokens) for r in a) // interval

    def decode():
        for _ in range(12):
            w.run_lm_decode(b)

    def detok():
        for k in range(n_windows):
            sel = [r for r in a
                   if (k + 1) * interval <= len(r.lm_output_audio_tokens)]
            for r in sel:
                r.next_audio_decode_idx = [k * interval]
            w.run_detokenize(sel)
        w.flush_detokenize()

    if threaded:
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ts = [threading.Thread(target=f) for f in (decode, detok)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(old)
    else:
        decode()
        detok()
    w.sync()
    tokens = [np.stack(r.lm_output_tokens) for r in b]
    pcm = [b"".join(_drain(r.output_audio)) for r in a]
    return tokens, pcm, n_windows


def _drain(q):
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


def test_dispatch_lock_two_threads_match_the_serial_run():
    tokens, pcm, n = _lock_run(threaded=False)
    assert n >= 2 and sum(map(len, pcm)) > 0
    for _ in range(3):
        t2, p2, _ = _lock_run(threaded=True)
        assert len(t2) == len(tokens)
        for x, y in zip(tokens, t2):
            np.testing.assert_array_equal(x, y)
        assert p2 == pcm


def test_entry_points_hold_the_dispatch_lock():
    w = _port_worker()
    for name in ("run_lm_prefill", "run_lm_decode", "run_lm_decode_multi",
                 "run_cold_start", "run_detokenize", "flush_detokenize",
                 "sync", "poll_resolved", "fail_request", "free_kv_cache"):
        assert getattr(type(w), name).__wrapped__, name
    seen = []
    orig = w._run_detokenize

    def probe(reqs):
        # another thread cannot take the lock while an entry point runs
        t = threading.Thread(target=lambda: seen.append(
            w._dispatch_lock.acquire(timeout=0.05)))
        t.start()
        t.join()
        return orig(reqs)

    w._run_detokenize = probe
    w.run_detokenize([treq.Request(request_id="x", prompt="p")])
    assert seen == [False]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--dp-size", "2", "--enable-disaggregation"],
    ["--dp-size", "2", "--scheduler-type", "disaggregation"],
])
def test_dp_with_disaggregation_exits_2(argv):
    with pytest.raises(SystemExit) as e:
        launch.main(["--model", "dummy", "--device", "cpu", *argv])
    assert e.value.code == 2


def test_cards_missing_names_the_count():
    p = launch.build_parser()
    a = p.parse_args(["--dp-size", "2"])
    assert launch.cards_missing(a, 2) is None
    assert "2 CUDA cards" in launch.cards_missing(a, 1)
    assert "has 1" in launch.cards_missing(a, 1)
    a = p.parse_args(["--enable-disaggregation"])
    assert "has 1" in launch.cards_missing(a, 1)
    assert launch.cards_missing(a, 2) is None
    assert launch.cards_missing(p.parse_args([]), 1) is None
    cpu = p.parse_args(["--device", "cpu", "--dp-size", "2"])
    assert launch.cards_missing(cpu, 0) is None


def test_launcher_stops_the_daemons_when_cards_are_missing(monkeypatch):
    """``--device cuda --dp-size 2`` on a machine with one card (faked):
    the daemons it spawned are stopped and the launcher exits non-zero
    naming the count."""
    import vox_serve_tpu_torch.models as models
    import vox_serve_tpu_torch.server.api as api

    made = []

    class FakeServer:
        def __init__(self, **kw):
            self.kw = kw
            self.cleaned = False
            made.append(self)

        def cleanup(self):
            self.cleaned = True

    monkeypatch.setattr(api, "APIServer", FakeServer)
    monkeypatch.setattr(models, "resolve_device", lambda name: name)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        launch.main(["--model", "dummy", "--dp-size", "2"])
    assert "--dp-size 2 needs 2 CUDA cards; this machine has 1" in str(
        e.value.code)
    assert made and made[0].cleaned
    assert made[0].kw["dp_size"] == 2


# ---------------------------------------------------------------------------
# two cards
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_split_worker_on_two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")

    def run(index):
        cfg = WorkerConfig(max_batch_size=2, num_pages=64, page_size=8,
                           prefill_token_buckets=(32,),
                           max_prefill_requests=2, seed=0,
                           detokenizer_device_index=index)
        w = ModelWorker(DummyLM(max_tokens=24, device="cuda:0", seed=0),
                        cfg)
        req = treq.Request(request_id="d", prompt="hello disagg")
        w.run_lm_prefill([req])
        for _ in range(12):
            w.run_lm_decode([req])
        w.sync()
        req.next_audio_decode_idx = [0]
        w.run_detokenize([req])
        w.flush_detokenize()
        return w, req, b"".join(_drain(req.output_audio))

    w, req, pcm = run(1)
    assert w.split and w.detokenizer_device == torch.device("cuda", 1)
    assert all(a.device == torch.device("cuda", 1)
               for a in w.codec_cache.values())
    assert w.step_stats()["graphs_by_device"]["cuda:1"] == [
        list(k) for k in w._steps.steps if k[0] == "detok"]
    assert not w._chains_enabled()
    PortDisagg(model_worker=w, max_batch_size=2, connect=False)
    _, ref_req, ref = run(None)
    assert len(pcm) == w.model.output_audio_length * 2
    assert pcm == ref
    assert req.lm_output_tokens[0].tolist() == \
        ref_req.lm_output_tokens[0].tolist()
