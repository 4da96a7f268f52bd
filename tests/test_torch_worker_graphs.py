"""The worker's decode steps as captured CUDA graphs, on the card only
(marker ``cuda``; skipped where CUDA is unavailable), against the same step
bodies run eagerly from the same state:

* a single-step graph gives the eager step's greedy tokens and pool bytes,
  at batch buckets 1 and 4, two table widths, over the bf16 and int8
  combined pools and the bf16 pair;
* a fused k=4 graph gives four eager single steps' tokens, slot state and
  KV bytes token for token (the fused step takes all four steps' pages up
  front, request by request, and single steps take them step by step, so
  the same tokens may sit on other pages);
* under sampling, replays on the same inputs draw new noise, and codebook
  0's distribution over 2000 draws matches the eager step's within a total
  variation distance of 0.12 (two empirical distributions of 2000 draws
  over at most 20 tokens differ by ~0.05 on average);
* a replay adds its captured kernel launches to the counters, the capture
  adds none, and no eager decode step is counted but the test's own.

This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_worker_graphs.py -q
"""

import numpy as np
import pytest
import torch

from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.params import tree_leaves
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

TV_TOL = 0.12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda")


def _qwen3(device, decoder_dim=64):
    bf16 = torch.bfloat16
    m = Qwen3TTSLM(
        dtype=bf16, device=device, detokenize_interval=4,
        debug_backbone=BackboneConfig(
            vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            qk_norm=True, rope_theta=1e6, dtype=bf16),
        debug_depth=DepthConfig(
            hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True,
            dtype=bf16),
        debug_codec=Qwen3CodecConfig(
            codebook_dim=32, codebook_size=2048, latent_dim=48,
            decoder_dim=decoder_dim, hidden_size=32, intermediate_size=64,
            head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
            num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
            upsampling_ratios=(2, 2), vq_dim=16))
    m.sampling_config = m.sampling_config.replace(greedy=True,
                                                  max_tokens=200)
    return m


def _prefilled(device, kv, monkeypatch, **kw):
    """A debug Qwen3 worker on the card with four prefilled requests."""
    if kv == "pair":
        monkeypatch.setenv("VOX_KV_COMBINED", "0")
    else:
        monkeypatch.delenv("VOX_KV_COMBINED", raising=False)
    w = ModelWorker(_qwen3(device), WorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,),
        warmup=False, kv_quant="int8" if kv == "int8" else "none", **kw))
    assert (w.v_pages is not None) == (kv == "pair")
    reqs = [Request(request_id=f"r{i}", prompt="ab" * (i + 1))
            for i in range(4)]
    w.run_lm_prefill(reqs)
    w.sync()
    return w, reqs


def _state(w):
    return [t for t in (w.k_pages, w.v_pages, w.last_tokens, w.rep_cache,
                        w.feedback) if t is not None]


def _snap(w, reqs):
    return ([t.clone() for t in _state(w)],
            [(r.kv_token_len, list(r.kv_pages), dict(r.extras))
             for r in reqs], w.allocator._free[:], w.allocator._reserved)


def _restore(w, reqs, snap):
    tensors, fields, free, reserved = snap
    for t, s in zip(_state(w), tensors):
        t.copy_(s)
    for r, (t, pages, extras) in zip(reqs, fields):
        r.kv_token_len, r.kv_pages, r.extras = t, list(pages), dict(extras)
    w.allocator._free[:] = free
    w.allocator._free_set = set(free)
    w.allocator._reserved = reserved


def _kv_by_token(w, reqs):
    """Each request's KV rows in token order, read through its pages."""
    out = []
    for r in reqs:
        pages = torch.tensor(r.kv_pages, device=w.device)
        for pool in (w.k_pages, w.v_pages):
            if pool is None:
                continue
            if w.v_pages is None:  # combined (L, P, page, 2KH, D)
                rows = pool[:, pages].flatten(1, 2)[:, :r.kv_token_len]
            else:  # pair (L, KH, P, page, D)
                rows = pool[:, :, pages].flatten(2, 3)[:, :, :r.kv_token_len]
            out.append(rows.contiguous().view(torch.uint8))
    return out


def _eager(w, key, pack):
    body, _ = w._build_step(key)
    return body(torch.from_numpy(pack).to(w.device))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "pair"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("wi", [0, 1])
def test_single_step_graph_matches_eager_on_card(cuda_device, monkeypatch,
                                                  kv, B, wi):
    w, reqs = _prefilled(cuda_device, kv, monkeypatch)
    reqs = reqs[:B]
    W = w.table_width_buckets[wi]
    key = ("decode", B, W)
    w._steps.get(key)  # capture first: its warm-up touches only padding
    snap = _snap(w, reqs)
    pack, hard = w._plan_decode(reqs, B, W)
    assert not hard
    got = w._steps.run(key, pack).clone()
    after = [t.clone() for t in _state(w)]
    assert w.eager_calls["decode"] == 0
    _restore(w, reqs, snap)
    ref = _eager(w, key, pack)
    assert w.eager_calls["decode"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    for a, b in zip(after, _state(w)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "pair"])
def test_fused_graph_equals_four_eager_steps_on_card(cuda_device,
                                                     monkeypatch, kv):
    w, reqs = _prefilled(cuda_device, kv, monkeypatch, fused_decode_steps=4,
                         fused_decode_buckets=(4,))
    W = w.table_width_buckets[0]
    key = ("decode_multi", 4, 4, W)
    w._steps.get(key)
    snap = _snap(w, reqs)
    pack, hard = w._plan_decode_multi(reqs, 4, 4, W)
    assert not hard
    got = w._steps.run(key, pack).clone()
    by_token = _kv_by_token(w, reqs)
    slots = [t.clone() for t in _state(w)[-3:]]  # last tokens, rep, feedback
    _restore(w, reqs, snap)
    ref = []
    for _ in range(4):
        p, _ = w._plan_decode(reqs, 4, W)
        ref.append(_eager(w, ("decode", 4, W), p))
    torch.cuda.synchronize()
    assert torch.equal(got, torch.stack(ref))
    for a, b in zip(by_token, _kv_by_token(w, reqs)):
        assert torch.equal(a, b)
    for a, b in zip(slots, _state(w)[-3:]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _fixed_input_pack(w, B, W):
    """Every row feeds token 5 at position 0 into page 1 (an override), so
    each replay sees the same inputs whatever it sampled before."""
    pack = w._padded_pack(("decode", B, W))
    (overrides, override_mask, _g, _p, page_ids, _o, _s, slot_ids,
     tables) = w._decode_pack_views(pack, 1)
    overrides[:] = 5
    override_mask[:] = 1
    page_ids[:] = 1
    tables[:, 0] = 1
    slot_ids[:] = np.arange(B)
    return pack


@pytest.mark.cuda
def test_replays_draw_new_noise_with_eager_distribution_on_card(
        cuda_device):
    m = DummyLM(dtype=torch.bfloat16, device=cuda_device)
    m.sampling_config = SamplingConfig(top_k=20, temperature=2.0)
    w = ModelWorker(m, WorkerConfig(max_batch_size=4, num_pages=8,
                                    page_size=8, prefill_token_buckets=(16,),
                                    warmup=False))
    W = w.table_width_buckets[0]
    key = ("decode", 4, W)
    pack = _fixed_input_pack(w, 4, W)
    graph = [w._steps.run(key, pack).clone() for _ in range(500)]
    eager = [_eager(w, key, pack) for _ in range(500)]
    graph = torch.cat(graph).flatten().cpu().numpy()
    eager = torch.cat(eager).flatten().cpu().numpy()
    assert not np.array_equal(graph[:4], graph[4:8])
    assert len(set(graph[:400:4].tolist())) > 1  # row 0 across replays
    assert len(np.unique(eager)) >= 3
    p = np.bincount(graph, minlength=64) / graph.size
    q = np.bincount(eager, minlength=64) / eager.size
    assert 0.5 * np.abs(p - q).sum() < TV_TOL


@pytest.mark.cuda
def test_replay_counts_captured_launches_on_card(cuda_device, monkeypatch):
    w, reqs = _prefilled(cuda_device, "bf16", monkeypatch)
    L = w.model.backbone_config.num_layers
    W = w.table_width_buckets[0]
    before = kernels.launch_counts()
    step = w._steps.get(("decode", 4, W))
    assert kernels.launch_counts() == before  # capture counts nothing
    assert [(fn.__name__, field, n) for fn, field, n in step.counts] == [
        ("paged_decode_attention", "launches", L)]
    for _ in range(3):
        pack, _ = w._plan_decode(reqs, 4, W)
        w._steps.run(("decode", 4, W), pack)
    after = kernels.launch_counts()
    assert after["paged_decode_attention"] == \
        before["paged_decode_attention"] + 3 * L
    assert {k: after[k] - before[k] for k in after
            if k != "paged_decode_attention"} == {
        k: 0 for k in after if k != "paged_decode_attention"}
    assert w.eager_calls["decode"] == 0
    assert w.step_stats()["decode_steps"] == 3


# -- prefill, detokenize, chained first-chunk decode and the cold chain ----


def _full_state(w):
    """Every tensor a step may write: the pools, the slot state and the
    codec-cache leaves."""
    return _state(w) + tree_leaves(w.codec_cache)


def _graph_vs_eager(w, key, inputs):
    """Replay key's graph on inputs, then run its eager body from the same
    state: outputs and every state tensor must match bit for bit."""
    w._steps.get(key)  # capture first: its warm-up touches only padding
    saved = [t.clone() for t in _full_state(w)]
    got = w._steps.run(key, *inputs)
    got = tuple(t.clone() for t in (got if isinstance(got, tuple)
                                    else (got,)))
    after = [t.clone() for t in _full_state(w)]
    for t, s in zip(_full_state(w), saved):
        t.copy_(s)
    body, _ = w._build_step(key)
    ref = body(*(torch.from_numpy(a).to(w.device) for a in inputs))
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    assert w.eager_calls[key[0]] == 1  # the test's own eager call only
    for a, b in zip(got, ref):
        assert torch.equal(a, b), key
    for a, b in zip(after, _full_state(w)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), key
    return got


def _first_chunk_worker(device, model=None, **kw):
    return ModelWorker(model or _qwen3(device), WorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64, 128), max_prefill_requests=4,
        warmup=False, first_chunk_frames=2, fused_decode_steps=2,
        fused_decode_buckets=(1, 4), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n_req", [1, 3])
def test_prefill_graph_matches_eager_on_card(cuda_device, n_req):
    """A padded bucket (64 tokens, 4 rows) over 1 or 3 prompts."""
    w = _first_chunk_worker(cuda_device)
    reqs = [Request(request_id=f"p{i}", prompt="ab" * (i + 2))
            for i in range(n_req)]
    reqs = w._admit_prefills(reqs)
    arr = w._prefill_host_arrays(reqs)
    assert arr["T"] == 64 and sum(r.input_length for r in reqs) < 64
    out = _graph_vs_eager(w, ("prefill", 64, 4), w._prefill_inputs(arr))
    assert out[0].shape == (4, w.model.n_codebooks)


@pytest.mark.cuda
def test_detokenize_graph_matches_eager_on_card(cuda_device):
    w = _first_chunk_worker(cuda_device)
    rng = np.random.default_rng(0)
    C, B, L = w.model.n_codebooks, 4, 4
    pack = np.zeros((B * L * C + B,), np.int32)
    toks, slots = w._detok_pack_views(pack, B, L, C)
    toks[:3] = rng.integers(0, 2048, (3, L, C))
    slots[:] = [2, 0, 1, w.config.max_batch_size]  # a padded row
    for leaf in tree_leaves(w.codec_cache):  # non-zero streaming state
        if leaf.is_floating_point():
            leaf.normal_()
    out = _graph_vs_eager(w, ("detok", B, L), (pack,))
    assert out[0].dtype == torch.int16 and out[0].shape[0] == B


@pytest.mark.cuda
def test_bf16_codec_detokenize_graph_matches_eager_on_card(cuda_device,
                                                          monkeypatch):
    """codec_dtype bfloat16 with the fused stacks: every codec tensor is
    bf16 before anything is captured, the detokenize graph replays its
    eager body bit for bit, and each replay launches K2's bf16 entry (the
    two decoder blocks longer than 54 samples: 2 stacks, 18 launches) and
    never the float32 one."""
    monkeypatch.setenv("VOX_FUSED_RESUNIT", "1")
    w = _first_chunk_worker(cuda_device, _qwen3(cuda_device, 256),
                            codec_dtype="bfloat16")
    assert w.codec_dtypes() == ["bfloat16"]
    rng = np.random.default_rng(2)
    C, B, L = w.model.n_codebooks, 4, 4
    pack = np.zeros((B * L * C + B,), np.int32)
    toks, slots = w._detok_pack_views(pack, B, L, C)
    toks[:3] = rng.integers(0, 2048, (3, L, C))
    slots[:] = [2, 0, 1, w.config.max_batch_size]
    for leaf in tree_leaves(w.codec_cache):
        if leaf.is_floating_point():
            leaf.normal_()
    before = kernels.launch_counts()
    out = _graph_vs_eager(w, ("detok", B, L), (pack,))
    assert out[0].dtype == torch.int16 and out[0].shape[0] == B
    step = w._steps.get(("detok", B, L))
    counts = {(fn.__name__, field): n for fn, field, n in step.counts}
    assert counts == {("fused_resunit_stack_bf16", "stacks"): 2,
                      ("fused_resunit_stack_bf16", "launches"): 18}
    after = kernels.launch_counts()
    # one replay and the test's own eager call
    assert after["fused_resunit_stack_bf16"] == (
        before["fused_resunit_stack_bf16"] + 36)
    assert after["fused_resunit_stack"] == before["fused_resunit_stack"]


@pytest.mark.cuda
def test_chained_first_chunk_graphs_match_eager_on_card(cuda_device):
    """decode_multi_detok after a prefill, and the cold chain over the two
    packs staged as one buffer."""
    w = _first_chunk_worker(cuda_device)
    W0 = w.table_width_buckets[0]
    req = Request(request_id="m", prompt="abcd")
    w.run_lm_prefill([req])
    w.sync()
    pack, hard = w._plan_decode_multi([req], 2, 1, W0)
    assert not hard
    sampled, pcm = _graph_vs_eager(w, ("decode_multi_detok", 1, 2, W0),
                                   (pack,))
    assert sampled.shape == (2, 1, w.model.n_codebooks)
    assert pcm.dtype == torch.int16

    cold = Request(request_id="c", prompt="abc")
    (cold,) = w._admit_prefills([cold])
    parr = w._prefill_host_arrays([cold])
    cold.extras["inflight"] = 1
    dpack, hard = w._plan_decode_multi([cold], 2, 1, W0)
    assert not hard
    inputs = (np.concatenate([parr["pack"], dpack]),
              *w._prefill_inputs(parr)[1:])
    sampled, pcm = _graph_vs_eager(w, ("cold_chain", 64, 2), inputs)
    assert sampled.shape == (3, 1, w.model.n_codebooks)


@pytest.mark.cuda
def test_two_in_flight_detokenize_replays_keep_both_results(cuda_device):
    """Two batches of one (B, L) key in flight at detokenize depth 2: each
    pending entry owns its PCM (a copy made right after its replay), so
    the second replay does not overwrite the first's."""
    w = _first_chunk_worker(cuda_device, pipeline_depth=2,
                            detok_pipeline_depth=2)
    rng = np.random.default_rng(1)
    reqs = [Request(request_id=f"d{i}") for i in range(2)]
    for r in reqs:
        w.admit(r)
    wins = [rng.integers(0, 2048, (4, w.model.n_codebooks)).astype(np.int32)
            for _ in reqs]
    saved = [t.clone() for t in tree_leaves(w.codec_cache)]
    for r, win in zip(reqs, wins):
        w._dispatch_detok([win], [r.slot], 4, [(r, 0, 4, 4)], [])
    assert len(w._pending_detok) == 2 and w.max_pending_detok == 2
    w.flush_detokenize()
    piped = [r.output_audio.get() for r in reqs]
    for t, s in zip(tree_leaves(w.codec_cache), saved):
        t.copy_(s)
    for r, win in zip(reqs, wins):  # one at a time, each read at once
        out = w._steps.run(("detok", 1, 4), np.concatenate(
            [win.ravel(), [r.slot]]).astype(np.int32))
        assert out[0].cpu().numpy().tobytes() == piped.pop(0)


@pytest.mark.cuda
def test_resunit_stacks_count_per_replay_on_card(cuda_device, monkeypatch):
    """K2 inside a detokenize graph: the capture counts nothing, and each
    replay adds the stacks and launches its capture made (here the two
    decoder blocks longer than 54 samples, 128 and 64 channels: 2 stacks,
    18 launches)."""
    monkeypatch.setenv("VOX_FUSED_RESUNIT", "1")
    w = _first_chunk_worker(cuda_device, _qwen3(cuda_device, 256))
    k2 = kernels.wrappers()["fused_resunit_stack"]
    before = kernels.counters()
    step = w._steps.get(("detok", 1, 4))
    assert kernels.counters() == before
    counts = {(fn.__name__, field): n for fn, field, n in step.counts}
    assert counts == {("fused_resunit_stack", "stacks"): 2,
                      ("fused_resunit_stack", "launches"): 18}
    pack = np.zeros((4 * w.model.n_codebooks + 1,), np.int32)
    for _ in range(3):
        w._steps.run(("detok", 1, 4), pack)
    assert k2.stacks == before["fused_resunit_stack", "stacks"] + 6
    assert k2.launches == before["fused_resunit_stack", "launches"] + 54
    assert w.step_stats()["captured"]["detok 1 4"] == {
        "replays": 3, "fused_resunit_stack.launches": 18,
        "fused_resunit_stack.stacks": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [(128, (41,)), (128, (20, 33, 9)),
                                    (1024, (42, 42, 42, 42)),
                                    (1024, (300, 5, 77, 1, 211))])
def test_k3_at_a_padded_bucket_matches_plain_on_card(cuda_device, T, lens):
    """K3 as the prefill graphs run it: a token bucket holding 1-5 prompts
    and a padded tail (segment -1); valid rows against the plain
    version."""
    g = torch.Generator().manual_seed(T + len(lens))
    H, KH, D = 16, 8, 128
    seg = torch.full((T,), -1, dtype=torch.int32)
    c = 0
    for i, n in enumerate(lens):
        seg[c:c + n] = i
        c += n
    q, k, v = (torch.randn((T, h, D), generator=g).to(torch.bfloat16)
               .to(cuda_device) for h in (H, KH, KH))
    seg = seg.to(cuda_device)
    out = kernels.ragged_prefill_attention(q, k, v, seg)
    ref = kernels.ragged_prefill_attention_plain(q, k, v, seg)
    valid = seg >= 0
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_cold_chain_replays_draw_new_noise_with_eager_distribution_on_card(
        cuda_device):
    """The cold chain draws its prefill's and its k steps' noise from the
    one registered generator: replays of fixed (padded) inputs sample anew
    each time, with the eager body's distribution."""
    m = DummyLM(dtype=torch.bfloat16, device=cuda_device)
    m.sampling_config = SamplingConfig(top_k=20, temperature=2.0)
    w = ModelWorker(m, WorkerConfig(
        max_batch_size=2, num_pages=16, page_size=8,
        prefill_token_buckets=(16,), max_prefill_requests=2, warmup=False,
        fused_decode_steps=2, fused_decode_buckets=(1,),
        first_chunk_frames=2))
    key = ("cold_chain", 16, 2)
    assert key in w.warmup_keys()
    body, inputs = w._build_step(key)
    graph = [w._steps.run(key, *inputs)[0].clone() for _ in range(800)]
    dev = [torch.from_numpy(a).to(cuda_device) for a in inputs]
    eager = [body(*dev)[0].clone() for _ in range(800)]
    graph = torch.stack(graph).cpu().numpy()  # (n, k + 1, 1, C)
    eager = torch.stack(eager).cpu().numpy()
    assert graph.shape[1:] == (3, 1, 1)
    for step in range(3):  # the prefill's sample and the two steps'
        assert len(set(graph[:, step].ravel().tolist())) > 1
    # the three draws of all replays pooled (2400 samples a side)
    p = np.bincount(graph.ravel(), minlength=64) / graph.size
    q = np.bincount(eager.ravel(), minlength=64) / eager.size
    assert 0.5 * np.abs(p - q).sum() < TV_TOL
