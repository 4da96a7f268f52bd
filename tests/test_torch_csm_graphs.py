"""CSM through the worker's captured CUDA graphs, on the card only (marker
``cuda``; skipped where CUDA is unavailable): a small CSM at the served
head layout (a GQA group of 4 at head dim 64, Llama-3.1 rope; the small
Mimi of the CPU tests) in bf16, each graph replayed and its step body run
eagerly from the same state:

* the prefill graph (K3, one launch per layer) and a single-step decode
  graph (K1, one launch per layer), each with the 31-codebook depth step
  through K6, give the eager step's greedy tokens and every state tensor
  bit for bit;
* the detokenize graph (Mimi with its per-slot transformer ring, then the
  watermark) gives the eager body's int16 PCM and codec-cache rows: bit
  for bit with the float32 codec, whose PCM is shown to be the marked one;
  with the bf16 codec within 2^-5 of max |eager| (the bf16 codec's own
  error against float32, `chip_smoke.py`'s tolerance: cuDNN may take
  another bf16 convolution algorithm inside a capture, where the free
  workspace differs).

This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_csm_graphs.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_worker_graphs import (_full_state, _graph_vs_eager,  # noqa
                                      cuda_device)
from vox_serve_tpu_torch.codecs.mimi import MimiConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.csm import CSMLM
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.params import tree_leaves, tree_map
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.watermark import apply_watermark
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig
from vox_serve_tpu_torch.worker.base import _pcm16


def _csm_worker(device, **kw):
    bf16 = torch.bfloat16
    m = CSMLM(
        dtype=bf16, device=device,
        debug_backbone=BackboneConfig(
            vocab_size=2051, hidden_size=128, num_layers=2, num_heads=8,
            num_kv_heads=2, head_dim=64, intermediate_size=256,
            rope_theta=5e5, llama31_rope_scaling=True, dtype=bf16),
        debug_depth=DepthConfig(
            hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=128, intermediate_size=128, max_seq=33, dtype=bf16),
        debug_codec=MimiConfig(
            vq_dim=8, num_filters=8, upsample_ratios=(4, 3), hidden_size=16,
            intermediate_size=32, head_dim=8, num_heads=2, num_kv_heads=2,
            num_layers=2, sliding_window=6))
    m.sampling_config = m.sampling_config.replace(greedy=True,
                                                  max_tokens=200)
    return ModelWorker(m, WorkerConfig(
        max_batch_size=4, num_pages=64, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=4, warmup=False,
        **kw))


def _counts(w, key):
    return {(fn.__name__, field): n
            for fn, field, n in w._steps.get(key).counts}


def _k6_counts(w):
    """K6's launches in one frame of the depth loop: 31 forwards (codebooks
    0-1, then one per codebook up to 31), each two norms a layer and the
    final one, the other three kernels once a layer."""
    L = w.model.depth_config.num_layers
    return {("depth_add_rms_norm", "launches"): 31 * (2 * L + 1),
            ("depth_qkv_rope", "launches"): 31 * L,
            ("depth_attention", "launches"): 31 * L,
            ("depth_silu_mul", "launches"): 31 * L}


@pytest.mark.cuda
def test_prefill_and_decode_graphs_match_eager_on_card(cuda_device):
    w = _csm_worker(cuda_device)
    reqs = w._admit_prefills([Request(request_id=f"p{i}",
                                      prompt="ab" * (i + 2))
                              for i in range(3)])
    arr = w._prefill_inputs(w._prefill_host_arrays(reqs))
    out = _graph_vs_eager(w, ("prefill", 64, 4), arr)
    assert out[0].shape == (4, 33) and not out[0][:, -1].any()
    assert _counts(w, ("prefill", 64, 4)) == {
        ("ragged_prefill_attention", "launches"): 2, **_k6_counts(w)}
    w._dispatch_prefill(reqs, w._prefill_host_arrays(reqs))
    w.sync()
    B, W = 4, w.table_width_buckets[0]
    pack, hard = w._plan_decode(reqs, B, W)
    assert not hard
    out = _graph_vs_eager(w, ("decode", B, W), (pack,))
    assert out[0].shape == (B, 33)
    assert _counts(w, ("decode", B, W)) == {
        ("paged_decode_attention", "launches"): 2, **_k6_counts(w)}


def _detok_inputs(w, seed=0):
    """A padded detokenize pack over three slots and the sentinel, with
    non-zero streaming state in every codec-cache row."""
    rng = np.random.default_rng(seed)
    C, B, L = 33, 4, 10
    pack = np.zeros((B * L * C + B,), np.int32)
    toks, slots = w._detok_pack_views(pack, B, L, C)
    toks[:3] = rng.integers(0, 2051, (3, L, C))
    slots[:] = [2, 0, 1, w.config.max_batch_size]  # a padded row
    w.codec_cache["pos"][:] = torch.tensor([3, 40, 0, 7, 9])
    w.codec_cache["attn_len"][:] = torch.tensor([3, 6, 0, 6, 6])
    for leaf in tree_leaves(w.codec_cache):
        if leaf.is_floating_point():
            leaf.normal_()
    return pack, toks, slots, ("detok", B, L)


@pytest.mark.cuda
def test_watermarked_detokenize_graph_matches_eager_on_card(cuda_device):
    w = _csm_worker(cuda_device)
    assert w.watermark_params["pattern"].dtype == torch.float32
    pack, toks, slots, key = _detok_inputs(w)
    w._steps.get(key)  # its warm-up writes the sentinel row
    saved = [t.clone() for t in tree_leaves(w.codec_cache)]
    before = kernels.launch_counts()
    pcm = _graph_vs_eager(w, key, (pack,))[0]
    assert kernels.launch_counts() == before  # Mimi runs no custom kernel
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (4, 1, 10 * 24)
    # the codec alone from the same state, then the watermark: the graph's
    # PCM is the marked one
    for t, s0 in zip(tree_leaves(w.codec_cache), saved):
        t.copy_(s0)
    idx = torch.from_numpy(slots.astype(np.int64)).to(cuda_device)
    audio, _ = w.model.detokenize(
        w.model.codec_params, torch.from_numpy(toks.copy()).to(cuda_device),
        tree_map(lambda a: a[idx], w.codec_cache))
    marked = apply_watermark(w.watermark_params, w.watermark_cfg,
                             audio[:, 0].float())
    assert torch.equal(pcm[:, 0], _pcm16(marked))
    assert not torch.equal(pcm[:, 0], _pcm16(audio[:, 0]))


@pytest.mark.cuda
def test_bf16_watermarked_detokenize_graph_matches_eager_on_card(
        cuda_device):
    """The codec cast to bf16 before capture, the watermark in float32:
    the graph's PCM and codec-cache rows against its eager body's from
    the same state, within 2^-5 of max |eager| (see the module
    docstring)."""
    w = _csm_worker(cuda_device, codec_dtype="bfloat16")
    assert w.codec_dtypes() == ["bfloat16"]
    assert w.watermark_params["pattern"].dtype == torch.float32
    pack, _, _, key = _detok_inputs(w)
    w._steps.get(key)
    saved = [t.clone() for t in _full_state(w)]
    got = w._steps.run(key, pack).clone()
    after = [t.clone() for t in _full_state(w)]
    for t, s0 in zip(_full_state(w), saved):
        t.copy_(s0)
    body, _ = w._build_step(key)
    ref = body(torch.from_numpy(pack).to(cuda_device))
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and got.shape == ref.shape
    for a, b in [(got, ref), *zip(after, _full_state(w))]:
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2.0 ** -5 * max(b.abs().max(), 1.0)
