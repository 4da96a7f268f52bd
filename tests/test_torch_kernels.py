"""The port's CUDA kernels (ops/kernels.py): wrapper dispatch, launch
counting and build keying on the CPU, and — on the card only (marker
``cuda``; skipped where CUDA is unavailable) — each kernel against its plain
PyTorch version. This file imports neither jax nor the JAX package, so the
card tests run on a machine without them:

    python -m pytest tests/test_torch_kernels.py -q

Tolerance on the card: 2e-2 absolute (bf16 output rounding, 2^-8
relative, plus float32 summation order).
"""

import pytest
import torch

from vox_serve_tpu_torch.ops import kernels

torch.set_num_threads(1)
CARD_TOL = 2e-2


def _decode_case(seed, B, H, KH, D, L, P, page, maxp):
    g = torch.Generator().manual_seed(seed)
    pool = torch.randn((L, P, page, 2 * KH, D), generator=g)
    q = torch.randn((B, H, D), generator=g)
    seq = torch.randint(1, maxp * page + 1, (B,), generator=g,
                        dtype=torch.int32)
    seq[1] = 1  # a padded row: seq_len 1 on scratch page 0
    tables = torch.zeros((B, maxp), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g).to(torch.int32) + 1
    for b in range(B):
        n = -(-int(seq[b]) // page)
        tables[b, :n] = perm[b * maxp:b * maxp + n]
    tables[1] = 0
    return q, pool, tables, seq


def _prefill_case(seed, T, H, KH, D, segs):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((T, H, D), generator=g)
    k = torch.randn((T, KH, D), generator=g)
    v = torch.randn((T, KH, D), generator=g)
    seg = torch.full((T,), -1, dtype=torch.int32)
    off = 0
    for sid, n in enumerate(segs):
        seg[off:off + n] = sid
        off += n
    return q, k, v, seg


def test_kernel_wrappers_raise_for_other_devices():
    q = torch.zeros((2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        kernels.paged_decode_attention(q, q, 0, q, q)
    with pytest.raises(ValueError):
        kernels.ragged_prefill_attention(q, q, q, q)


def test_cpu_path_runs_plain_versions_without_counting_launches():
    kernels.reset_launch_counts()
    q, pool, tables, seq = _decode_case(5, 4, 8, 4, 32, 2, 30, 8, 5)
    out = kernels.paged_decode_attention(q, pool, 1, tables, seq)
    torch.testing.assert_close(out, kernels.paged_decode_attention_plain(
        q, pool, 1, tables, seq), atol=0, rtol=0)
    q2, k2, v2, seg = _prefill_case(5, 40, 8, 4, 32, (40,))
    kernels.ragged_prefill_attention(q2, k2, v2, seg)
    assert kernels.launch_counts() == {"paged_decode_attention": 0,
                                       "ragged_prefill_attention": 0}


def test_kernel_sources_and_build_path_are_keyed_by_content():
    path = kernels._library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libvox_kernels_")
    for name in kernels._SOURCES:
        src = (kernels._CSRC / name).read_text()
        assert "extern \"C\" int vox_" in src
        assert "sm_90a" in src
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda_device):
    q, pool, tables, seq = _decode_case(6, 9, 16, 8, 128, 3, 100, 16, 8)
    args = [q.bfloat16().to(cuda_device), pool.bfloat16().to(cuda_device),
            2, tables.to(cuda_device), seq.to(cuda_device)]
    before = kernels.paged_decode_attention.launches
    out = kernels.paged_decode_attention(*args)
    ref = kernels.paged_decode_attention_plain(*args)
    assert kernels.paged_decode_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() < CARD_TOL


@pytest.mark.cuda
def test_k1_kernel_zero_length_row_on_card(cuda_device):
    q, pool, tables, seq = _decode_case(7, 3, 16, 8, 128, 1, 20, 16, 2)
    seq[0] = 0
    out = kernels.paged_decode_attention(
        q.bfloat16().to(cuda_device), pool.bfloat16().to(cuda_device), 0,
        tables.to(cuda_device), seq.to(cuda_device))
    assert torch.count_nonzero(out[0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T,segs", [(300, (120, 3, 90, 40)), (17, (17,)),
                                    (64, (1, 1, 30))])
def test_k3_kernel_matches_plain_on_card(cuda_device, T, segs):
    q, k, v, seg = _prefill_case(8, T, 16, 8, 128, segs)
    args = [x.bfloat16().to(cuda_device) for x in (q, k, v)]
    args.append(seg.to(cuda_device))
    out = kernels.ragged_prefill_attention(*args)
    ref = kernels.ragged_prefill_attention_plain(*args)
    valid = (seg >= 0).to(cuda_device)
    err = (out[valid].float() - ref[valid].float()).abs().max().item()
    assert err < CARD_TOL
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_kernels_reject_wrong_dtype_on_card(cuda_device):
    q, pool, tables, seq = _decode_case(9, 2, 16, 8, 128, 1, 20, 16, 2)
    with pytest.raises(ValueError, match="dtype"):
        kernels.paged_decode_attention(
            q.to(cuda_device), pool.bfloat16().to(cuda_device), 0,
            tables.to(cuda_device), seq.to(cuda_device))


@pytest.mark.parametrize("H,KH,D,max_group,ok", [
    (16, 8, 128, 8, True), (16, 8, 16, 32, True), (12, 8, 128, 8, False),
    (24, 8, 128, 8, False), (16, 8, 256, 8, False), (16, 8, 100, 8, False),
])
def test_kernel_shape_limits_are_checked_before_launch(H, KH, D, max_group,
                                                       ok):
    if ok:
        kernels._check_heads(H, KH, D, max_group)
    else:
        with pytest.raises(ValueError):
            kernels._check_heads(H, KH, D, max_group)
