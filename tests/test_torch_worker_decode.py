"""Port parity, worker decode (vox_serve_tpu_torch/worker/base.py against
vox_serve_tpu/worker/base.py) on the CPU: the block-table width lattice,
the packed single-step and fused k-step uploads (element for element, for
the same requests and pages), the fused-k schedule and its validation, the
block-table limit, padded rows against the slot state, a hard stop with
steps in flight, and the decode flags of the daemon and the launcher.

Where a decode step runs here, it runs eagerly: the same step bodies that
the card captures as CUDA graphs.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import launch as tlaunch
from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.scheduler import Scheduler
from vox_serve_tpu_torch.scheduler_entry import build_parser as daemon_parser
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)


def _greedy_dummy(max_tokens=16):
    m = DummyLM(max_tokens=max_tokens)
    m.sampling_config = SamplingConfig(greedy=True, max_tokens=max_tokens)
    return m


def debug_qwen3(**kw):
    """Qwen3-TTS at debug widths (depth loop, feedback, repetition cache,
    streaming codec)."""
    return Qwen3TTSLM(
        dtype=torch.float32, device="cpu", detokenize_interval=4,
        debug_backbone=BackboneConfig(
            vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            qk_norm=True, rope_theta=1e6, dtype=torch.float32),
        debug_depth=DepthConfig(
            hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True,
            dtype=torch.float32),
        debug_codec=Qwen3CodecConfig(
            codebook_dim=32, codebook_size=2048, latent_dim=48,
            decoder_dim=64, hidden_size=32, intermediate_size=64,
            head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
            num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
            upsampling_ratios=(2, 2), vq_dim=16), **kw)


def _pair_workers(**kw):
    """The port's and the JAX package's workers over DummyLM, one config
    (the same prefill buckets)."""
    kw.setdefault("prefill_token_buckets", (64,))
    tw = ModelWorker(DummyLM(), WorkerConfig(**kw))
    jw = JWorker(JDummyLM(), JWorkerConfig(warmup=False, **kw))
    return tw, jw


@pytest.mark.parametrize("kw", [
    dict(max_batch_size=4, num_pages=64, page_size=8),
    dict(max_batch_size=4, num_pages=64, page_size=16,
         prefill_token_buckets=(1024,), fused_decode_steps=4,
         fused_decode_buckets=(1, 4)),
    dict(max_batch_size=2, num_pages=64, page_size=8,
         table_width_buckets=(1, 40, 300)),
])
def test_width_lattice_matches_jax(kw):
    tw, jw = _pair_workers(**kw)
    assert tw.max_pages_per_seq == jw.max_pages_per_seq
    assert tw.table_width_buckets == jw.table_width_buckets
    assert tw.config.decode_buckets == jw.config.decode_buckets


def _twin_requests(tw, jw, specs):
    """The same requests in both packages, their pages drawn from each
    worker's allocator in the same order: (input_length, tokens in KV,
    generated, in flight, reserved pages)."""
    out = []
    for n, (L, t, gen, inflight, reserve) in enumerate(specs):
        pair = []
        for w, cls in ((tw, Request), (jw, JRequest)):
            r = cls(request_id=f"r{n}")
            r.slot = n
            r.input_length = L
            r.kv_token_len = t
            r.kv_pages = w.allocator.alloc(-(-t // w.config.page_size))
            w.allocator.reserve(reserve)
            r.extras.update(kv_reserved=reserve, inflight=inflight)
            r.lm_output_tokens = [np.zeros((1,), np.int32)] * gen
            pair.append(r)
        out.append(pair)
    return [p[0] for p in out], [p[1] for p in out]


# input_length, kv tokens, generated, in flight, reserved: a request at a
# page boundary, one with steps in flight, one mid-page, one at the
# block-table limit (hard stop: its row stays padded)
SPECS = [(10, 16, 6, 0, 4), (5, 9, 2, 2, 4), (7, 12, 4, 1, 4)]


def test_single_step_pack_matches_jax():
    tw, jw = _pair_workers(max_batch_size=4, num_pages=64, page_size=8)
    limit = tw.max_pages_per_seq * 8
    specs = SPECS + [(3, limit, 20, 0, 0)]
    treqs, jreqs = _twin_requests(tw, jw, specs)
    C = 1
    seen = {}

    def fake_get(phase, bucket):
        def fn(params, packed, k, v, rep, fb, last, key, counter):
            seen["pack"] = np.asarray(packed)
            return (jnp.zeros((packed.shape[0], C), jnp.int32), k, v, rep,
                    fb, last)
        return fn

    jw._get_lm_fn = fake_get
    B = tw._decode_bucket(len(treqs))
    W = tw._table_width(treqs)
    pack, hard = tw._plan_decode(treqs, B, W)
    jw.run_lm_decode(jreqs)
    np.testing.assert_array_equal(pack, seen["pack"])
    assert hard == {3}
    assert [r.kv_pages for r in treqs] == [r.kv_pages for r in jreqs]
    assert treqs[3].done_lm_generation and jreqs[3].done_lm_generation


@pytest.mark.parametrize("K,B", [(4, 4), (3, 8)])
def test_fused_pack_matches_jax(K, B):
    tw, jw = _pair_workers(max_batch_size=8, num_pages=64, page_size=8,
                           fused_decode_steps=4, fused_decode_buckets=(4, 8))
    treqs, jreqs = _twin_requests(tw, jw, SPECS)
    pack, hard = tw._plan_decode_multi(treqs, K, B)
    jarr, jhard = jw._plan_decode_multi(jreqs, K, B)
    np.testing.assert_array_equal(pack, jarr["pack"])
    assert hard == jhard == set()
    assert [r.extras["inflight"] for r in treqs] == \
        [r.extras["inflight"] for r in jreqs]
    assert [r.extras["kv_reserved"] for r in treqs] == \
        [r.extras["kv_reserved"] for r in jreqs]


def _reqs(n):
    out = []
    for i in range(n):
        r = Request(request_id=f"k{i}", done_lm_prefill=True)
        r.lm_output_tokens.append(np.array([1], np.int32))
        r.kv_token_len = 4
        r.kv_pages = [0]
        out.append(r)
    return out


def test_fused_k_schedule_selects_per_bucket_k():
    """As tests/test_fused_decode.py holds the JAX worker: the schedule
    maps a batch to its bucket's k, and the scheduler dispatches it."""
    base = dict(max_batch_size=8, num_pages=64, page_size=8,
                prefill_token_buckets=(64,), max_prefill_requests=4,
                fused_decode_steps=4, fused_decode_buckets=(1, 4, 8),
                fused_k_schedule=(4, 2, 4))
    w = ModelWorker(_greedy_dummy(), WorkerConfig(**base))
    assert [w.fused_k_for(n) for n in (1, 2, 4, 5, 9)] == [4, 2, 2, 4, 1]
    s = Scheduler(model_worker=w, max_batch_size=8, connect=False)
    assert s._fused_decode_steps(_reqs(1)) == 4
    assert s._fused_decode_steps(_reqs(3)) == 2
    assert w.can_decode_multi(_reqs(3), 2)
    assert w.can_decode_multi(_reqs(3), 4)
    assert not w.can_decode_multi(_reqs(3), 3)
    # both the bucket's k and fused_decode_steps are captured per width
    assert {k[2] for k in w.warmup_keys() if k[0] == "decode_multi"
            and k[1] == 4} == {2, 4}

    w2 = ModelWorker(_greedy_dummy(), WorkerConfig(**base,
                                                   fused_min_batch=5))
    s2 = Scheduler(model_worker=w2, max_batch_size=8, connect=False)
    assert s2._fused_decode_steps(_reqs(3)) == 2  # latency regime
    s2._load_pressure = 6  # backlog pushes past fmin -> latch up
    assert s2._fused_decode_steps(_reqs(3)) == 4


def test_fused_k_schedule_validation():
    base = dict(max_batch_size=4, num_pages=64, page_size=8,
                prefill_token_buckets=(64,), fused_decode_steps=3,
                fused_decode_buckets=(1, 4))
    with pytest.raises(ValueError, match="one .*k per fused bucket"):
        ModelWorker(_greedy_dummy(), WorkerConfig(**base,
                                                  fused_k_schedule=(3,)))
    with pytest.raises(ValueError, match="fused_k_schedule entries"):
        ModelWorker(_greedy_dummy(), WorkerConfig(**base,
                                                  fused_k_schedule=(3, 5)))


def test_fused_decode_respects_block_table_limit():
    w = ModelWorker(_greedy_dummy(), WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(64,),
        max_prefill_requests=2, fused_decode_steps=4,
        fused_decode_buckets=(2,)))
    req = Request(request_id="lim", prompt="x")
    w.run_lm_prefill([req])
    w.sync()
    limit = w.max_pages_per_seq * w.config.page_size
    req.kv_token_len = limit - 2
    assert not w.can_decode_multi([req], 4)
    req.kv_token_len = limit - 8
    assert w.can_decode_multi([req], 4)
    assert not w.can_decode_multi([req], 1)
    assert not w.can_decode_multi(_reqs(3), 4)  # no bucket holds 3


def test_warmup_keys_cover_buckets_and_widths():
    w = ModelWorker(_greedy_dummy(max_tokens=200), WorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,),
        fused_decode_steps=4, fused_decode_buckets=(1, 4)))
    widths = w.table_width_buckets
    assert widths == (16, 32, 48)
    # the JAX warmup's order: prefill buckets, decode, fused decode, then
    # detokenize at the interval (4) and the catch-up windows (16, 8)
    assert w.warmup_keys() == (
        [("prefill", 64, 8)]
        + [("decode", B, W) for B in (1, 2, 4) for W in widths]
        + [("decode_multi", B, 4, W) for B in (1, 4) for W in widths]
        + [("detok", B, L) for L in (4, 16, 8) for B in (1, 2, 4)])


def _state(w):
    rows = w.config.max_batch_size
    return ([w.last_tokens[:rows].clone(), w.feedback[:rows].clone(),
             w.rep_cache[:rows].clone()], w.k_pages[:, 1:].clone())


def test_padded_rows_leave_slot_state_untouched():
    """A fully padded step (scratch page 0, the sentinel slot), single and
    fused, writes no slot's row and no page but page 0."""
    model = debug_qwen3()
    model.sampling_config = model.sampling_config.replace(max_tokens=40)
    w = ModelWorker(model, WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=8,
        prefill_token_buckets=(64,),
        fused_decode_steps=2, fused_decode_buckets=(2,)))
    reqs = [Request(request_id=f"p{i}", prompt=p)
            for i, p in enumerate(("ab", "cde"))]
    w.run_lm_prefill(reqs)
    w.run_lm_decode(reqs)
    w.sync()
    rows, pool = _state(w)
    assert all(torch.count_nonzero(r) for r in rows)
    W = w.table_width_buckets[0]
    for key in (("decode", 2, W), ("decode_multi", 2, 2, W)):
        out = w._steps.run(key, w._padded_pack(key))
        assert out.shape[-2:] == (2, model.n_codebooks)
        rows2, pool2 = _state(w)
        for a, b in zip(rows, rows2):
            assert torch.equal(a, b), key
        assert torch.equal(pool, pool2), key


class _NoStopDummy(DummyLM):
    def is_stop(self, token_ids):
        return False


def _run_to_block_limit(depth):
    m = _NoStopDummy(max_tokens=16)
    m.sampling_config = SamplingConfig(greedy=True)
    w = ModelWorker(m, WorkerConfig(
        max_batch_size=1, num_pages=64, page_size=8,
        prefill_token_buckets=(16,),
        pipeline_depth=depth))
    req = Request(request_id="hs", prompt="hard stop",
                  sampling_config=SamplingConfig(greedy=True,
                                                 max_tokens=200))
    w.run_lm_prefill([req])
    for _ in range(w.max_pages_per_seq * 8 + 4):
        if req.done_lm_generation:
            break
        w.run_lm_decode([req])
    w.sync()
    assert req.finish_reason == "length"
    assert req.extras["inflight"] == 0
    w.free_kv_cache(req)
    assert w.allocator.num_free == 63
    return w, req


def test_hard_stop_with_steps_in_flight_loses_no_tokens():
    """Reaching the block-table limit with two steps in flight resolves
    them before the stop: every token fed into the KV is kept."""
    _, sync_req = _run_to_block_limit(0)
    w, req = _run_to_block_limit(2)
    limit = w.max_pages_per_seq * 8
    assert w.max_pending == 3  # two steps stayed in flight behind the new
    assert len(req.lm_output_tokens) == 1 + limit - req.input_length
    assert [int(t[0]) for t in req.lm_output_tokens] == \
        [int(t[0]) for t in sync_req.lm_output_tokens]


def test_decode_flags_reach_the_daemon():
    args = daemon_parser().parse_args(
        ["--model", "dummy", "--no-warmup", "--pipeline-depth", "2",
         "--fused-decode-steps", "4", "--fused-decode-buckets", "1,4",
         "--fused-k-schedule", "4,2", "--fused-min-batch", "3",
         "--decode-buckets", "1,4", "--table-width-buckets", "16,64"])
    assert (args.no_warmup, args.pipeline_depth, args.fused_decode_steps,
            args.fused_decode_buckets, args.fused_k_schedule,
            args.fused_min_batch, args.decode_buckets,
            args.table_width_buckets) == (True, 2, 4, "1,4", "4,2", 3,
                                          "1,4", "16,64")
    largs = tlaunch.build_parser().parse_args(
        ["--no-warmup", "--fused-decode-steps", "4", "--pipeline-depth",
         "2"])
    assert (largs.no_warmup, largs.fused_decode_steps,
            largs.pipeline_depth) == (True, 4, 2)
    src = inspect.getsource(tlaunch.main)
    for key in ("no_warmup", "pipeline_depth", "fused_decode_steps",
                "fused_decode_buckets", "fused_k_schedule", "fused_min_batch",
                "decode_buckets", "table_width_buckets"):
        assert f'"{key}"' in src, f"{key} missing from scheduler_args"
