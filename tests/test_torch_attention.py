"""Port parity, attention: the plain versions of K1 (paged decode over the
combined pool) and K3 (ragged causal prefill) against the JAX package, and
the device dispatch of the kernel wrappers.

On the CPU the wrappers run the plain versions; the kernels themselves are
tested on the card in ``test_torch_kernels.py``.

Tolerances (float32): 1e-5 against the dense JAX oracles (same formulas,
other summation order); 2e-3 against the Pallas prefill kernel in interpret
mode, as the JAX package's own test holds it (online softmax vs dense).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.ops import attention as jattn
from vox_serve_tpu.ops.pallas_prefill import pallas_ragged_prefill
from vox_serve_tpu_torch.ops import attention as tattn
from vox_serve_tpu_torch.ops import kernels

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_case(seed, B=5, H=8, KH=4, D=32, L=3, P=40, page=8, maxp=6):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((L, P, page, 2 * KH, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    seq = rng.integers(1, maxp * page + 1, (B,)).astype(np.int32)
    seq[1] = 1  # a padded row: seq_len 1 ...
    tables = np.zeros((B, maxp), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        n = -(-int(seq[b]) // page)
        tables[b, :n] = perm[b * maxp:b * maxp + n]  # non-contiguous pages
    tables[1] = 0  # ... on scratch page 0
    return q, pool, tables, seq


@pytest.mark.parametrize("seed,layer", [(0, 0), (1, 2)])
def test_plain_decode_matches_jax_combined_gather(seed, layer):
    q, pool, tables, seq = _decode_case(seed)
    jmeta = jattn.AttnMetadata(False, None, None,
                               block_tables=jnp.asarray(tables),
                               seq_lens=jnp.asarray(seq))
    ref = np.asarray(jattn._combined_decode_gather(
        jnp.asarray(q), jnp.asarray(pool), layer, jmeta, None))
    tmeta = tattn.AttnMetadata(False, None, None, block_tables=_t(tables),
                               seq_lens=_t(seq))
    got = tattn._combined_decode_gather(_t(q), _t(pool), layer, tmeta)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
    # the dispatching entry point takes the plain path for CPU tensors
    got2 = tattn.paged_attention_decode(_t(q), _t(pool), None, layer, tmeta)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_plain_decode_zero_length_row_is_zero():
    q, pool, tables, seq = _decode_case(2)
    seq[0] = 0
    out = kernels.paged_decode_attention_plain(_t(q), _t(pool), 0,
                                               _t(tables), _t(seq))
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[2]) > 0


def _prefill_case(seed, T, H=8, KH=4, D=32, segs=(100, 37, 64)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    v = rng.standard_normal((T, KH, D)).astype(np.float32)
    seg = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    off = 0
    for sid, ln in enumerate(segs):
        seg[off:off + ln] = sid
        pos[off:off + ln] = np.arange(ln)
        off += ln
    return q, k, v, seg, pos


@pytest.mark.parametrize("T,segs", [(256, (100, 37, 64)), (50, (50,)),
                                    (33, (5, 1, 20))])
def test_plain_prefill_matches_jax_dense(T, segs):
    q, k, v, seg, pos = _prefill_case(3, T, segs=segs)
    jmeta = jattn.AttnMetadata(True, None, None, segment_ids=jnp.asarray(seg),
                               q_positions=jnp.asarray(pos))
    ref = np.asarray(jattn.ragged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmeta))
    tmeta = tattn.AttnMetadata(True, None, None, segment_ids=_t(seg),
                               q_positions=_t(pos))
    got = tattn.ragged_prefill_attention(_t(q), _t(k), _t(v), tmeta).numpy()
    valid = seg >= 0  # padding rows are don't-care
    np.testing.assert_allclose(got[valid], ref[valid], atol=ATOL, rtol=ATOL)


def test_plain_prefill_matches_jax_pallas_kernel_interpret():
    """K3's own TPU kernel, run as the JAX package's tests run it on the CPU
    (Pallas interpret mode), against the port's plain version."""
    q, k, v, seg, pos = _prefill_case(4, 256, D=128)
    jmeta = jattn.AttnMetadata(True, jnp.zeros((256,), jnp.int32),
                               jnp.zeros((256,), jnp.int32),
                               segment_ids=jnp.asarray(seg),
                               q_positions=jnp.asarray(pos))
    ref = np.asarray(pallas_ragged_prefill(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jmeta,
                                           interpret=True))
    got = kernels.ragged_prefill_attention_plain(_t(q), _t(k), _t(v),
                                                 _t(seg)).numpy()
    valid = seg >= 0
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-3, rtol=2e-3)
