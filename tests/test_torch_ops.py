"""Port parity, ops: norms, rope, the combined-pool KV write, the page
allocator and sampling, each held against the JAX package on the same
numpy inputs (float32, CPU).

Tolerances: 1e-5 absolute for elementwise ops (float32 rounding of the same
formulas, summed in another order); sampling masks and greedy ids must match
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu import sampling as jsamp
from vox_serve_tpu.ops import attention as jattn
from vox_serve_tpu.ops import norms as jnorms
from vox_serve_tpu.ops import rope as jrope
from vox_serve_tpu_torch import sampling as tsamp
from vox_serve_tpu_torch.ops import attention as tattn
from vox_serve_tpu_torch.ops import norms as tnorms
from vox_serve_tpu_torch.ops import rope as trope
from vox_serve_tpu_torch.ops.kv_cache import (KVCacheConfig, PageAllocator,
                                              PageAllocatorError,
                                              alloc_kv_pages)

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                     offset))
    got = tnorms.rms_norm(_t(x), _t(w), 1e-6, offset).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 48)) * 3 + 1).astype(np.float32)
    w, b = (rng.standard_normal((48,)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-5))
    got = tnorms.layer_norm(_t(x), _t(w), _t(b), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_norms_keep_input_dtype():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    w = torch.ones(16, dtype=torch.bfloat16)
    assert tnorms.rms_norm(x, w).dtype == torch.bfloat16
    assert tnorms.layer_norm(x, w, w).dtype == torch.bfloat16


@pytest.mark.parametrize("rope_dim", [None, 32])
def test_rope_matches_jax(rope_dim):
    rng = np.random.default_rng(2)
    T, H, KH, D = 9, 4, 2, 64
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    pos = rng.integers(0, 3000, (T,)).astype(np.int32)
    rd = rope_dim or D
    jf = jrope.rope_frequencies(rd, theta=1e6)
    tf = trope.rope_frequencies(rd, theta=1e6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(pos), jf, rope_dim=rope_dim)
    tq, tk = trope.apply_rope(_t(q), _t(k), _t(pos), tf, rope_dim=rope_dim)
    # angles reach 3000 rad: f32 sin/cos differ in the last ulps
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    if rope_dim:
        np.testing.assert_array_equal(tq.numpy()[..., rope_dim:],
                                      q[..., rope_dim:])


@pytest.mark.parametrize("head_dim,theta", [(128, 5e5), (64, 5e5),
                                             (16, 5e5)])
def test_llama31_rope_matches_jax(head_dim, theta):
    """Llama-3.1 frequency scaling (Orpheus's Llama-3.2-3B: theta 5e5, head
    dim 128): the inverse frequencies at 1e-7 relative, then the rotation
    over positions past the old 8192-token context."""
    jf = jrope.rope_frequencies(head_dim, theta=theta, llama31_scaling=True)
    tf = trope.rope_frequencies(head_dim, theta=theta, llama31_scaling=True)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-7,
                               atol=0)
    # the rule does scale: long wavelengths divided by 8, short ones kept
    plain = trope.rope_frequencies(head_dim, theta=theta)
    assert tf[0] == plain[0]
    if head_dim >= 64:
        assert torch.isclose(tf[-1], plain[-1] / 8.0)
    rng = np.random.default_rng(head_dim)
    T, H, KH = 7, 6, 2
    q = rng.standard_normal((T, H, head_dim)).astype(np.float32)
    k = rng.standard_normal((T, KH, head_dim)).astype(np.float32)
    pos = rng.integers(0, 12000, (T,)).astype(np.int32)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(pos), jf)
    tq, tk = trope.apply_rope(_t(q), _t(k), _t(pos), tf)
    # angles reach 12000 rad: f32 sin/cos differ in the last ulps
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)


def test_kv_write_matches_jax_combined_layout():
    rng = np.random.default_rng(3)
    L, P, page, KH, D, T = 2, 6, 4, 2, 16, 7
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    v = rng.standard_normal((T, KH, D)).astype(np.float32)
    ids = np.array([1, 1, 1, 1, 3, 3, 0], np.int32)   # last row: scratch pad
    offs = np.array([0, 1, 2, 3, 0, 1, 0], np.int32)
    jpool = jnp.zeros((L, P, page, 2 * KH, D), jnp.float32)
    jmeta = jattn.AttnMetadata(True, jnp.asarray(ids), jnp.asarray(offs))
    ref, _ = jattn.write_kv_prefill(jpool, None, 1, jnp.asarray(k),
                                    jnp.asarray(v), jmeta)
    cfg = KVCacheConfig(L, P, page, KH, D, dtype=torch.float32,
                        combined=True)
    tpool, none = alloc_kv_pages(cfg, "cpu")
    assert none is None and tuple(tpool.shape) == (L, P, page, 2 * KH, D)
    tmeta = tattn.AttnMetadata(True, _t(ids), _t(offs))
    before = tpool.data_ptr()
    tattn.write_kv_prefill(tpool, None, 1, _t(k), _t(v), tmeta)
    assert tpool.data_ptr() == before  # in place
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(ref))
    # K at even, V at odd combined heads
    np.testing.assert_array_equal(tpool[1, 3, 1, 0::2].numpy(), k[5])
    np.testing.assert_array_equal(tpool[1, 3, 1, 1::2].numpy(), v[5])


def test_page_allocator_scratch_and_reservations():
    a = PageAllocator(6)
    assert a.num_free == 5
    pages = a.alloc(2)
    assert PageAllocator.SCRATCH_PAGE not in pages
    a.reserve(3)
    assert not a.can_alloc(1)
    with pytest.raises(PageAllocatorError):
        a.alloc(1)
    assert a.alloc(1, reserved=1)
    with pytest.raises(PageAllocatorError):
        a.free([0])
    a.free(pages)
    with pytest.raises(PageAllocatorError):
        a.free(pages[:1])  # double free


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _logits(seed, shape=(3, 2, 50)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3


@pytest.mark.parametrize("name,arg", [("top_k", 7), ("top_k", 0),
                                      ("top_p", 0.8), ("min_p", 0.1)])
def test_sampling_masks_match_jax_exactly(name, arg):
    x = _logits(4)
    jfn = getattr(jsamp, f"_mask_{name}")
    tfn = getattr(tsamp, f"_mask_{name}")
    ref = np.asarray(jfn(jnp.asarray(x), arg))
    got = tfn(_t(x), arg).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_array_equal(got[keep], ref[keep])


@pytest.mark.parametrize("window", [-1, 3])
def test_repetition_cache_and_penalty_match_jax(window):
    rng = np.random.default_rng(5)
    B, C, V = 2, 3, 11
    W = 1 if window == -1 else window
    cache = rng.random((B, W, C, V)) < 0.2
    ids = rng.integers(0, V, (B, C)).astype(np.int32)
    ref_c = np.asarray(jsamp.update_repetition_cache(
        jnp.asarray(cache), jnp.asarray(ids), global_window=window == -1))
    got_c = tsamp.update_repetition_cache(_t(cache), _t(ids),
                                          global_window=window == -1).numpy()
    np.testing.assert_array_equal(got_c, ref_c)
    x = _logits(6, (B, C, V))
    ref = np.asarray(jsamp.apply_repetition_penalty(
        jnp.asarray(x), jnp.asarray(ref_c), 1.3))
    got = tsamp.apply_repetition_penalty(_t(x), _t(got_c), 1.3).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_greedy_sample_and_update_match_jax():
    x = _logits(7, (4, 1, 50))
    cfg_kw = dict(greedy=True, repetition_penalty=1.2, repetition_window=-1)
    cache = np.random.default_rng(8).random((4, 1, 2, 50)) < 0.3
    jids, jc = jsamp.sample_and_update(
        jnp.asarray(x), jsamp.SamplingConfig(**cfg_kw), jax.random.key(0),
        jnp.asarray(cache))
    tids, tc = tsamp.sample_and_update(
        _t(x), tsamp.SamplingConfig(**cfg_kw), None, _t(cache))
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_gumbel_sampling_follows_the_masked_distribution():
    """Draws cannot match JAX bit for bit (different generators); they must
    stay inside the top-k support and follow softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    cfg = tsamp.SamplingConfig(top_k=4, temperature=0.7)
    g = torch.Generator().manual_seed(0)
    n = 20000
    ids = tsamp.sample(logits.expand(n, -1), cfg, g).numpy()
    assert set(np.unique(ids)) <= {0, 1, 2, 3}
    p = torch.softmax(logits[0, :4] / 0.7, dim=-1).numpy()
    freq = np.bincount(ids, minlength=6)[:4] / n
    # binomial standard error at n=20000 is < 0.0036; allow ~4 sigma
    np.testing.assert_allclose(freq, p, atol=0.015)
    # same seed -> same draws
    g2 = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        tsamp.sample(logits.expand(n, -1), cfg, g2).numpy(), ids)
