"""Port parity, KV overcommit (``kv_reserve_fraction``) on the CPU: the pages
reserved at admission and ``can_admit`` equal to the JAX worker's over a
grid, and serving under a pool too small for every request's whole budget,
where decode rows are deferred until a completion frees pages and every
request still completes with the JAX worker's greedy tokens.

Tolerances: page counts, admission decisions and tokens exact.
"""

import numpy as np
import pytest
import torch

from test_torch_first_chunk import _greedy_dummies
from test_torch_worker_decode import _pair_workers
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.sampling import SamplingConfig as JSamplingConfig
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.scheduler import Scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

FRACTIONS = (1.0, 0.5, 0.25, 0.05, 0.0)


@pytest.mark.parametrize("frac", FRACTIONS)
@pytest.mark.parametrize("page_size", [8, 16])
def test_reserve_pages_and_admission_match_jax(frac, page_size):
    tw, jw = _pair_workers(max_batch_size=4, num_pages=40,
                           page_size=page_size, kv_reserve_fraction=frac)
    for prompt in (1, 7, 40, 300):
        for max_tokens in (16, 64, 2048):
            assert (tw._gen_reserve_pages(prompt, max_tokens)
                    == jw._gen_reserve_pages(prompt, max_tokens))
    # admission as the pool fills: the same decisions at every level
    for held in (0, 10, 25, 37, 39):
        for w in (tw, jw):
            w.allocator.reserve(held)
        for prompt in (1, 9, 64, 200):
            assert tw.can_admit(prompt) == jw.can_admit(prompt)
        for w in (tw, jw):
            w.allocator.release_reservation(held)


def test_full_fraction_reserves_the_whole_budget():
    w = ModelWorker(_greedy_dummies(40)[0], WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(64,)))
    assert w.config.kv_reserve_fraction == 1.0
    # (48 - 8 prompt tokens + 8 slack) / 8 pages + 1
    assert w._gen_reserve_pages(8, 48) == 7
    w2 = ModelWorker(_greedy_dummies(40)[0], WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), kv_reserve_fraction=0.25))
    assert w2._gen_reserve_pages(8, 48) == 2  # ceil(7 * 0.25)


def _count_deferrals(worker):
    """Wrap the allocator so that every refused page is counted."""
    counts = {"refused": 0}
    real = worker.allocator.alloc

    def alloc(n, *a, **k):
        try:
            return real(n, *a, **k)
        except Exception:
            counts["refused"] += 1
            raise

    worker.allocator.alloc = alloc
    return counts


@pytest.mark.parametrize("kw", [
    {},
    dict(fused_decode_steps=4, fused_decode_buckets=(2,)),
])
def test_overcommitted_pool_defers_then_completes(kw):
    """A long request (16-token prompt, 48 tokens) and a short one that
    arrives while it runs (8-token prompt, 24 tokens) reserve half their
    budgets in a pool of 8 pages, which their budgets (6 + 3) overrun: the
    long request's row finds no page and is deferred until the short one
    completes; then it finishes too, with the JAX worker's tokens, and
    every page is back."""
    tm, jm = _greedy_dummies(max_tokens=14)
    cfg = dict(max_batch_size=2, num_pages=9, page_size=8,
               prefill_token_buckets=(64,), max_prefill_requests=2,
               kv_reserve_fraction=0.5, **kw)
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    out = []
    for w, sched, req, sc in ((tw, Scheduler, Request, SamplingConfig),
                              (jw, JScheduler, JRequest, JSamplingConfig)):
        counts = _count_deferrals(w)
        s = sched(model_worker=w, max_batch_size=2, connect=False)
        long = req(request_id="long", prompt="x" * 16,
                   sampling_config=sc(greedy=True, max_tokens=48))
        short = req(request_id="short", prompt="y" * 8,
                    sampling_config=sc(greedy=True, max_tokens=24))
        s.enqueue_request(long)
        for _ in range(400):
            if short not in s.active_requests and not short.done_all \
                    and len(long.lm_output_tokens) >= 10:
                s.enqueue_request(short)
            s._step()
            if long.done_all and short.done_all:
                break
        out.append(([long, short], counts["refused"]))
    (treqs, t_refused), (jreqs, j_refused) = out
    assert t_refused == j_refused > 0  # the long row was deferred
    for t, j in zip(treqs, jreqs):
        assert t.done_all and j.done_all
        assert t.finish_reason == j.finish_reason == "length"
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
    assert tw.allocator.num_free == tw.allocator.num_unreserved == 8
