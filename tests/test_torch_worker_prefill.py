"""Port parity, worker prefill (vox_serve_tpu_torch/worker/base.py against
vox_serve_tpu/worker/base.py) on the CPU: the one-buffer prefill upload
element for element, the token-bucket choice, the width-lattice floor
under several buckets, and a padded-bucket prefill's greedy tokens and KV
at the prompts' positions against the JAX worker (scratch page 0 takes
the padding, no other page moves).

A prefill here runs eagerly: the body that the card captures per token
bucket.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _qwen3_pair
from test_torch_worker_decode import _pair_workers
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)


def _twins(tw, jw, prompts):
    treqs = [Request(request_id=f"t{i}", prompt=p)
             for i, p in enumerate(prompts)]
    jreqs = [JRequest(request_id=f"j{i}", prompt=p)
             for i, p in enumerate(prompts)]
    return treqs, jreqs


@pytest.mark.parametrize("buckets,prompts", [
    ((64,), ("hello",)),
    ((16, 64), ("abc", "hello!", "x")),
    ((16, 64), ("a much longer prompt here", "and a second one")),
    ((8, 32, 128), ("one", "two", "three", "four")),
])
def test_prefill_pack_matches_jax(buckets, prompts):
    tw, jw = _pair_workers(max_batch_size=4, num_pages=64, page_size=8,
                           prefill_token_buckets=buckets,
                           max_prefill_requests=4)
    treqs, jreqs = _twins(tw, jw, prompts)
    treqs = tw._admit_prefills(treqs)
    jreqs = jw._admit_prefills(jreqs)
    assert [r.slot for r in treqs] == [r.slot for r in jreqs]
    assert [r.kv_pages for r in treqs] == [r.kv_pages for r in jreqs]
    t = tw._prefill_host_arrays(treqs)
    j = jw._prefill_host_arrays(jreqs)
    assert (t["T"], t["B"]) == (j["T"], j["B"])
    assert t["T"] == min(b for b in buckets
                         if b >= sum(r.input_length for r in treqs))
    np.testing.assert_array_equal(t["pack"], j["pack"])
    assert t["feat"] is j["feat"] is None and t["msk"] is j["msk"] is None
    # the padding: segment -1 on scratch page 0 at offsets arange %
    # page_size, padded rows on the sentinel slot
    _tok, _pos, seg, pages, offs, slots, _last = tw._prefill_pack_views(
        t["pack"], t["T"], t["B"], 1)
    n = sum(r.input_length for r in treqs)
    assert (seg[n:] == -1).all() and (pages[n:] == 0).all()
    np.testing.assert_array_equal(offs[n:], np.arange(n, t["T"]) % 8)
    assert (slots[len(treqs):] == 4).all()


def test_prefill_pack_with_feature_and_mask_planes_matches_jax():
    """Qwen3's text-embedding features and codebook masks ride beside the
    pack."""
    jm, tm = _qwen3_pair(max_tokens=20)
    kw = dict(max_batch_size=4, num_pages=200, page_size=8,
              max_prefill_requests=4, prefill_token_buckets=(32, 128))
    tw = ModelWorker(tm, WorkerConfig(**kw))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **kw))
    treqs, jreqs = _twins(tw, jw, ("hi", "hello there"))
    t = tw._prefill_host_arrays(tw._admit_prefills(treqs))
    j = jw._prefill_host_arrays(jw._admit_prefills(jreqs))
    assert t["T"] == j["T"]
    np.testing.assert_array_equal(t["pack"], j["pack"])
    np.testing.assert_allclose(t["feat"], j["feat"], atol=1e-6)
    np.testing.assert_array_equal(t["msk"], j["msk"])
    assert tw._prefill_inputs(t)[1:] == (t["feat"], t["msk"])


def test_prefill_bucket_choice_matches_jax():
    tw, jw = _pair_workers(max_batch_size=2, num_pages=64, page_size=8,
                           prefill_token_buckets=(32, 8, 128))
    assert tw.max_prefill_tokens == jw.max_prefill_tokens == 128
    for n in range(1, 129):
        assert tw.prefill_token_bucket(n) == jw.prefill_token_bucket(n)
    for w in (tw, jw):
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            w.prefill_token_bucket(129)


def test_prompt_beyond_the_largest_bucket_fails_only_itself():
    tw = ModelWorker(DummyLM(), WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(8, 16)))
    long, short = (Request(request_id="long", prompt="x" * 20),
                   Request(request_id="short", prompt="ok"))
    assert tw._admit_prefills([long, short]) == [short]
    assert long.done_all and "largest prefill bucket 16" in \
        long.finish_reason


@pytest.mark.parametrize("kw", [
    dict(prefill_token_buckets=(128, 1024), page_size=16),
    dict(prefill_token_buckets=(64, 256), page_size=8,
         fused_decode_steps=4, fused_decode_buckets=(1, 4)),
    dict(prefill_token_buckets=(32,), page_size=8,
         table_width_buckets=(1, 9, 40)),
])
def test_width_lattice_floor_takes_the_largest_bucket(kw):
    tw, jw = _pair_workers(max_batch_size=4, num_pages=512, **kw)
    assert tw.max_pages_per_seq == jw.max_pages_per_seq
    assert tw.table_width_buckets == jw.table_width_buckets
    top = max(kw["prefill_token_buckets"])
    # the smallest width holds the largest prompt plus two windows
    assert tw.table_width_buckets[0] * kw["page_size"] >= top


def test_old_prefill_field_and_flag_are_gone():
    with pytest.raises(TypeError):
        WorkerConfig(max_prefill_tokens=64)
    from vox_serve_tpu_torch import launch
    from vox_serve_tpu_torch.scheduler_entry import build_parser
    for parser in (launch.build_parser(), build_parser()):
        a = parser.parse_args(["--model", "dummy", "--prefill-buckets",
                               "16,64", "--max-prefill-requests", "3"])
        assert (a.prefill_buckets, a.max_prefill_requests) == ("16,64", 3)
        with pytest.raises(SystemExit):
            parser.parse_args(["--model", "dummy", "--max-prefill-tokens",
                               "64"])


def test_padded_bucket_prefill_matches_jax_tokens_and_kv():
    """Three prompts in a 128-token bucket (most of it padding): the greedy
    first tokens and the KV written at every prompt position equal the JAX
    worker's; the padding writes only scratch page 0."""
    jm, tm = _qwen3_pair(max_tokens=20)
    kw = dict(max_batch_size=4, num_pages=200, page_size=8,
              max_prefill_requests=4, prefill_token_buckets=(128,))
    tw = ModelWorker(tm, WorkerConfig(**kw))
    jw = JWorker(jm, JWorkerConfig(warmup=False, **kw))
    treqs, jreqs = _twins(tw, jw, ("hi", "hello there", "abc"))
    tw.run_lm_prefill(treqs)
    jw.run_lm_prefill(jreqs)
    tw.sync()
    jw.sync()
    assert tw.step_stats()["replays"] == {"prefill": 1}
    assert sum(r.input_length for r in treqs) < 128
    jk = np.asarray(jax.device_get(jw.k_pages))
    tk = tw.k_pages.numpy()
    # the JAX pool pads the head dim to the TPU's 128 lanes
    D = tk.shape[-1]
    assert tk.shape[:-1] == jk.shape[:-1] and not jk[..., D:].any()
    jk = jk[..., :D]
    used = {0}
    for t, j in zip(treqs, jreqs):
        np.testing.assert_array_equal(t.lm_output_tokens[0],
                                      j.lm_output_tokens[0])
        assert t.kv_pages == j.kv_pages
        pos = np.arange(t.input_length)
        pages = np.asarray(t.kv_pages)[pos // 8]
        np.testing.assert_allclose(tk[:, pages, pos % 8],
                                   jk[:, pages, pos % 8],
                                   atol=2e-4, rtol=2e-4)
        used |= set(t.kv_pages)
    others = [p for p in range(200) if p not in used]
    assert not tk[:, others].any()
