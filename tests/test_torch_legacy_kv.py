"""Port parity, the legacy head-major KV pair (K4's path): the pair write
against the JAX package, decode over the pair against JAX's Pallas legacy
kernels in interpret mode (the per-request kernel at D=128, the lane-folding
kernel at D=64), and the worker's ``VOX_KV_COMBINED=0`` escape hatch. CPU
only: the kernel itself is held against its plain version on the card.

Tolerances: pools equal; decode 1e-5 absolute (float32; the Pallas kernels
run an online softmax over 128-token chunks, the plain version a dense one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.ops import attention as jattn
from vox_serve_tpu.ops.pallas_attention import pallas_paged_attention_decode
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.ops import attention as tattn
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.ops.kv_cache import KVCacheConfig, alloc_kv_pages
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_pair_write_matches_jax():
    rng = np.random.default_rng(0)
    L, KH, P, page, D, T = 2, 3, 6, 4, 16, 7
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    v = rng.standard_normal((T, KH, D)).astype(np.float32)
    ids = np.array([1, 1, 1, 1, 3, 3, 0], np.int32)   # last row: scratch pad
    offs = np.array([0, 1, 2, 3, 0, 1, 0], np.int32)
    jk = jnp.zeros((L, KH, P, page, D), jnp.float32)
    jm = jattn.AttnMetadata(True, jnp.asarray(ids), jnp.asarray(offs))
    jk, jv = jattn.write_kv_prefill(jk, jk, 1, jnp.asarray(k), jnp.asarray(v),
                                    jm)
    cfg = KVCacheConfig(L, P, page, KH, D, dtype=torch.float32,
                        combined=False)
    tk, tv = alloc_kv_pages(cfg, "cpu")
    assert tuple(tk.shape) == tuple(tv.shape) == (L, KH, P, page, D)
    ptrs = (tk.data_ptr(), tv.data_ptr())
    tattn.write_kv_prefill(tk, tv, 1, _t(k), _t(v),
                           tattn.AttnMetadata(True, _t(ids), _t(offs)))
    assert (tk.data_ptr(), tv.data_ptr()) == ptrs  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[1, 2, 3, 1].numpy(), k[5, 2])


def _pair_case(seed, D, B=4, H=8, KH=4, L=2, page=16, maxp=5):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    k = rng.standard_normal((L, KH, P, page, D)).astype(np.float32)
    v = rng.standard_normal((L, KH, P, page, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    tables = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    seq = np.array([maxp * page, 1, 37, 2 * page + 3], np.int32)[:B]
    return q, k, v, tables, seq


@pytest.mark.parametrize("D", [128, 64])
def test_pair_decode_matches_jax_pallas_interpret(D):
    """D=128 runs JAX's per-request kernel, D=64 its fold kernel."""
    q, k, v, tables, seq = _pair_case(1, D)
    layer = 1
    jm = jattn.AttnMetadata(False, None, None,
                            block_tables=jnp.asarray(tables),
                            seq_lens=jnp.asarray(seq))
    ref = np.asarray(pallas_paged_attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer, jm,
        interpret=True))
    tm = tattn.AttnMetadata(False, None, None, block_tables=_t(tables),
                            seq_lens=_t(seq))
    got = tattn.paged_attention_decode(_t(q), _t(k), _t(v), layer, tm)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
    # and the JAX gather agrees too (seq_len >= 1 everywhere)
    gref = np.asarray(jattn.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer, jm))
    np.testing.assert_allclose(got.numpy(), gref, atol=ATOL, rtol=ATOL)


def test_pair_plain_zero_length_row_is_zero():
    q, k, v, tables, seq = _pair_case(2, 32)
    seq[0] = 0
    before = kernels.paged_decode_attention_pair.launches
    out = kernels.paged_decode_attention_pair(_t(q), _t(k), _t(v), 0,
                                              _t(tables), _t(seq))
    assert kernels.paged_decode_attention_pair.launches == before
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[2]) > 0


def test_worker_with_kv_combined_off_allocates_the_pair(monkeypatch):
    monkeypatch.setenv("VOX_KV_COMBINED", "0")
    model = DummyLM()
    w = ModelWorker(model, WorkerConfig(max_batch_size=2, num_pages=32,
                                        page_size=8, prefill_token_buckets=(64,),
                                        kv_quant="int8"))
    # quantized KV needs the combined layout: it falls back to full precision
    assert not w.kv_config.combined and w.kv_config.quant == "none"
    bb = model.backbone_config
    shape = (bb.num_layers, bb.num_kv_heads, 32, 8, bb.resolved_head_dim)
    assert tuple(w.k_pages.shape) == tuple(w.v_pages.shape) == shape
    assert model.kv_quant_scales is None
    req = Request(request_id="p", prompt="pair layout")
    w.run_lm_prefill([req])
    for _ in range(3):
        if req.done_lm_generation:
            break
        w.run_lm_decode([req])
    assert len(req.lm_output_tokens) >= 2
    assert torch.count_nonzero(w.k_pages) > 0
    assert torch.count_nonzero(w.v_pages) > 0
    w.free_kv_cache(req)
