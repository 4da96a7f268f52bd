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

from vox_serve_tpu_torch.codecs.layers import init_conv1d
from vox_serve_tpu_torch.ops import kernels, resunit

torch.set_num_threads(1)
CARD_TOL = 2e-2
K2_REL_TOL = 1e-4  # f32, relative to max |ref|: sum order, sinf vs sin
# bf16, relative to max |ref|: kernel and plain version round y, z and the
# output to bf16 at the same points; another f32 sum order flips a rounding
# by one bf16 step (2^-7 of the top binade), and a flip carried through the
# chained units can add one more
K2_BF16_REL_TOL = 2.0 ** -6


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


def _quantize(pool, dtype, g):
    """A random int8 pool, or a float8 cast of the float one."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, pool.shape, generator=g,
                             dtype=torch.int8)
    return pool.to(dtype)


def _pair(pool, KH):
    """(L, P, page, 2KH, D) combined -> the (L, KH, P, page, D) pair."""
    k = pool[:, :, :, 0::2].permute(0, 3, 1, 2, 4).contiguous()
    v = pool[:, :, :, 1::2].permute(0, 3, 1, 2, 4).contiguous()
    return k, v


def _units(g, C):
    def small():
        return torch.randn((C,), generator=g) * 0.2

    return [{"alpha1": small(), "beta1": small(),
             "conv1": init_conv1d(g, C, C, 7, "cpu"),
             "alpha2": small(), "beta2": small(),
             "conv2": init_conv1d(g, C, C, 1, "cpu")} for _ in range(3)]


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


def test_new_wrappers_raise_for_other_devices():
    q = torch.zeros((2, 4, 16), device="meta", dtype=torch.bfloat16)
    pool = torch.zeros((1, 4, 4, 4, 16), device="meta", dtype=torch.int8)
    tab = torch.zeros((2, 1), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.paged_decode_attention_quant(q, pool, 0, tab, tab[:, 0],
                                             (1.0, 1.0))
    with pytest.raises(ValueError):
        kernels.paged_decode_attention_pair(q, pool, pool, 0, tab, tab[:, 0])
    x = torch.zeros((1, 16, 64), device="meta")
    with pytest.raises(ValueError):
        resunit.fused_resunit_stack(x, [{}] * 3, None)


def test_wrapper_arguments_are_checked_before_dispatch():
    """Checks that hold on every device: a quantized pool needs its scales
    and only K1q takes it, a bf16 pool takes none, K2 wants a chunk longer
    than the widest halo and exactly three units."""
    q, pool, tables, seq = _decode_case(3, 2, 8, 4, 32, 1, 10, 8, 2)
    qpool = pool.to(torch.int8)
    with pytest.raises(ValueError, match="kv_scales"):
        kernels.paged_decode_attention(q, qpool, 0, tables, seq)
    with pytest.raises(ValueError, match="kv_scales"):
        kernels.paged_decode_attention(q, pool, 0, tables, seq,
                                       kv_scales=(1.0, 1.0))
    with pytest.raises(ValueError, match="K1q"):
        kernels.paged_decode_attention_quant(q, pool, 0, tables, seq,
                                             (1.0, 1.0))
    g = torch.Generator().manual_seed(0)
    units = _units(g, 8)
    with pytest.raises(ValueError, match="halo"):
        resunit.fused_resunit_stack(torch.zeros((1, 8, 54)), units, None)
    with pytest.raises(ValueError, match="3-unit"):
        resunit.fused_resunit_stack(torch.zeros((1, 8, 80)), units[:2], None,
                                    dilations=(1, 3))


def test_cpu_path_runs_plain_versions_without_counting_launches():
    kernels.reset_launch_counts()
    q, pool, tables, seq = _decode_case(5, 4, 8, 4, 32, 2, 30, 8, 5)
    out = kernels.paged_decode_attention(q, pool, 1, tables, seq)
    torch.testing.assert_close(out, kernels.paged_decode_attention_plain(
        q, pool, 1, tables, seq), atol=0, rtol=0)
    q2, k2, v2, seg = _prefill_case(5, 40, 8, 4, 32, (40,))
    kernels.ragged_prefill_attention(q2, k2, v2, seg)
    assert set(kernels.launch_counts().values()) == {0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_k1q_kernel_matches_plain_on_card(cuda_device, dtype):
    q, pool, tables, seq = _decode_case(10, 9, 16, 8, 128, 3, 100, 16, 8)
    g = torch.Generator().manual_seed(10)
    qpool = _quantize(pool, dtype, g).to(cuda_device)
    scales = (4.0 / 127.0, 3.0 / 127.0) if dtype == torch.int8 else (1.0,
                                                                     0.5)
    args = [q.bfloat16().to(cuda_device), qpool, 2, tables.to(cuda_device),
            seq.to(cuda_device)]
    before = dict(kernels.launch_counts())
    out = kernels.paged_decode_attention(*args, kv_scales=scales)
    ref = kernels.paged_decode_attention_plain(*args, kv_scales=scales)
    after = kernels.launch_counts()
    assert after["paged_decode_attention_quant"] == \
        before["paged_decode_attention_quant"] + 1
    assert after["paged_decode_attention"] == before["paged_decode_attention"]
    assert (out.float() - ref.float()).abs().max().item() < CARD_TOL


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_card(cuda_device):
    q, pool, tables, seq = _decode_case(11, 9, 16, 8, 128, 3, 100, 16, 8)
    k, v = _pair(pool.bfloat16(), 8)
    args = [q.bfloat16().to(cuda_device), k.to(cuda_device),
            v.to(cuda_device), 1, tables.to(cuda_device), seq.to(cuda_device)]
    before = kernels.paged_decode_attention_pair.launches
    out = kernels.paged_decode_attention_pair(*args)
    ref = kernels.paged_decode_attention_pair_plain(*args)
    assert kernels.paged_decode_attention_pair.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() < CARD_TOL
    # the same K/V in the combined layout give the same attention
    comb = kernels.paged_decode_attention(
        args[0], pool.bfloat16().to(cuda_device), 1, args[4], args[5])
    assert (out.float() - comb.float()).abs().max().item() < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,t1,t2", [
    (96, 3, 100, 137),    # T not a multiple of any time tile
    (192, 1, 55, 55),     # chunks of 55, just above the 54-sample gate
    (384, 3, 320, 75),
    (768, 1, 160, 160),   # B=1 at the widest block: the narrow time tile
    (768, 3, 55, 200),
])
def test_k2_kernel_matches_plain_on_card(cuda_device, C, B, t1, t2):
    """Whole (zero halos, and from caches) and over two streamed chunks,
    outputs and new caches within 1e-4 of max |ref| of the plain chain in
    float32 with TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(C + B)
    units = [{k: (v.to(cuda_device) if torch.is_tensor(v) else
                  {kk: vv.to(cuda_device) for kk, vv in v.items()})
              for k, v in u.items()} for u in _units(g, C)]
    x = (torch.randn((B, C, t1 + t2), generator=g) * 0.5).to(cuda_device)
    caches = [(torch.randn((B, C, 6 * d), generator=g) * 0.5).to(cuda_device)
              for d in (1, 3, 9)]
    before = kernels.launch_counts()["fused_resunit_stack"]
    pairs = []
    for cs in (None, caches):
        out, nc = resunit.fused_resunit_stack(x, units, cs)
        ref, rc = resunit.fused_resunit_stack_plain(x, units, cs)
        pairs += [(out, ref)] + ([] if cs is None else list(zip(nc, rc)))
    got, kc, want, pc = [], caches, [], caches
    for sl in (slice(0, t1), slice(t1, None)):
        o, kc = resunit.fused_resunit_stack(x[..., sl], units, kc)
        r, pc = resunit.fused_resunit_stack_plain(x[..., sl], units, pc)
        pairs += [(o, r)]
    pairs += list(zip(kc, pc))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        rel = (a - b).abs().max().item() / b.abs().max().item()
        assert rel < K2_REL_TOL
    # three launches per unit, three units per stack, four stacks
    assert kernels.launch_counts()["fused_resunit_stack"] == before + 36


def _k2_bf16_case(dev, C, B, T, seed):
    """bf16 units (as the codec serves them at codec_dtype bfloat16), x and
    caches on the card."""
    g = torch.Generator().manual_seed(seed)
    units = [{k: (v.to(dev, torch.bfloat16) if torch.is_tensor(v) else
                  {kk: vv.to(dev, torch.bfloat16) for kk, vv in v.items()})
              for k, v in u.items()} for u in _units(g, C)]
    x = (torch.randn((B, C, T), generator=g) * 0.5).to(dev, torch.bfloat16)
    caches = [(torch.randn((B, C, 6 * d), generator=g) * 0.5).to(
        dev, torch.bfloat16) for d in (1, 3, 9)]
    return units, x, caches


def _assert_k2_bf16_close(pairs):
    for a, b in pairs:
        assert a.dtype == b.dtype == torch.bfloat16
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        rel = ((a.float() - b.float()).abs().max().item()
               / b.float().abs().max().item())
        assert rel < K2_BF16_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("C,t1,t2", [
    (768, 160, 160),   # the four decoder blocks of a 10-frame detokenize
    (384, 800, 800),
    (192, 3200, 3200),
    (96, 9600, 9600),
    (96, 55, 82),      # a chunk just above the 54-sample gate, odd T
])
def test_k2_bf16_kernel_matches_plain_on_card(cuda_device, B, C, t1, t2):
    """K2 in bf16 against its bf16 plain version (the Pallas kernel's
    rounding points): whole with zero halos and from caches, then over two
    streamed chunks, outputs and new caches within 2^-6 of max |ref|; the
    launches counted under the bf16 counter only."""
    units, x, caches = _k2_bf16_case(cuda_device, C, B, t1 + t2, C + B)
    before = kernels.launch_counts()
    pairs = []
    for cs in (None, caches):
        out, nc = resunit.fused_resunit_stack(x, units, cs)
        ref, rc = resunit.fused_resunit_stack_plain(x, units, cs)
        pairs += [(out, ref)] + ([] if cs is None else list(zip(nc, rc)))
    kc = pc = caches
    for sl in (slice(0, t1), slice(t1, None)):
        o, kc = resunit.fused_resunit_stack(x[..., sl], units, kc)
        r, pc = resunit.fused_resunit_stack_plain(x[..., sl], units, pc)
        pairs += [(o, r)]
    pairs += list(zip(kc, pc))
    torch.cuda.synchronize()
    _assert_k2_bf16_close(pairs)
    after = kernels.launch_counts()
    assert after["fused_resunit_stack_bf16"] == (
        before["fused_resunit_stack_bf16"] + 36)
    assert after["fused_resunit_stack"] == before["fused_resunit_stack"]


@pytest.mark.cuda
def test_k2_bf16_kernel_in_a_captured_graph(cuda_device):
    """A captured graph of two streamed bf16 stacks replays what the eager
    launches compute, over inputs refilled in place between replays."""
    C, B, T = 192, 2, 160
    units, x, caches = _k2_bf16_case(cuda_device, C, B, T, 31)
    static_x = x.clone()
    static_c = [c.clone() for c in caches]

    def body():
        o, nc = resunit.fused_resunit_stack(static_x, units, static_c)
        return resunit.fused_resunit_stack(o, units, nc)

    body()  # packs the weights before capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_caches = body()
    for seed in (1, 2):
        _, x2, c2 = _k2_bf16_case(cuda_device, C, B, T, 31 + seed)
        static_x.copy_(x2)
        for s, c in zip(static_c, c2):
            s.copy_(c)
        graph.replay()
        o, nc = resunit.fused_resunit_stack_plain(x2, units, c2)
        ref, rc = resunit.fused_resunit_stack_plain(o, units, nc)
        torch.cuda.synchronize()
        _assert_k2_bf16_close([(g_out, ref), *zip(g_caches, rc)])


@pytest.mark.cuda
def test_new_kernels_reject_wrong_inputs_on_card(cuda_device):
    q, pool, tables, seq = _decode_case(12, 2, 16, 8, 128, 1, 20, 16, 2)
    qb, tb, sb = (q.bfloat16().to(cuda_device), tables.to(cuda_device),
                  seq.to(cuda_device))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="dtype"):  # a float16 pool
        kernels.paged_decode_attention(qb, pool.half().to(cuda_device), 0,
                                       tb, sb)
    k, v = _pair(pool.to(cuda_device), 8)
    with pytest.raises(ValueError, match="dtype"):  # a float32 pair
        kernels.paged_decode_attention_pair(qb, k, v, 0, tb, sb)
    with pytest.raises(ValueError, match="match"):  # a shorter V pool
        kernels.paged_decode_attention_pair(
            qb, k.bfloat16(), v.bfloat16()[:, :, :10].contiguous(), 0, tb,
            sb)
    g = torch.Generator().manual_seed(1)
    units = _units(g, 16)
    with pytest.raises(ValueError, match="float32"):  # float16: no kernel
        resunit.fused_resunit_stack(
            torch.zeros((1, 16, 80), device=cuda_device,
                        dtype=torch.float16), units, None)
    units12 = _units(g, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        resunit.fused_resunit_stack(torch.zeros((1, 12, 80),
                                                device=cuda_device),
                                    units12, None)
    assert kernels.launch_counts() == before


#: decode variants: pool element type and layout
_DECODE_VARIANTS = {"K1": (torch.bfloat16, "combined"),
                    "K1q int8": (torch.int8, "combined"),
                    "K1q f8": (torch.float8_e4m3fn, "combined"),
                    "K4": (torch.bfloat16, "pair")}


def _device_pool(dev, dtype, L, P, page, KH, D, seed):
    """A random combined pool on the card, and the dequant scales of a
    1-byte one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randn((L, P, page, 2 * KH, D), generator=g, device=dev)
    if dtype == torch.int8:
        return (torch.randint(-127, 128, pool.shape, generator=g, device=dev,
                              dtype=torch.int8), (4.0 / 127.0, 3.0 / 127.0))
    if dtype == torch.float8_e4m3fn:
        return pool.to(dtype), (1.0, 0.5)
    return pool.bfloat16(), None


def _decode_fns(variant, pool, scales):
    """(kernel, plain) of one decode variant over layer 1 of ``pool`` (a
    combined pool; the pair variant reads its head-major copy), each called
    as f(q, tables, seq_lens); the kernel also takes ``scratch``."""
    if _DECODE_VARIANTS[variant][1] == "pair":
        k, v = _pair(pool, pool.shape[3] // 2)

        def kernel(q, tb, sq, scratch=None):
            return kernels.paged_decode_attention_pair(q, k, v, 1, tb, sq,
                                                       scratch=scratch)

        def plain(q, tb, sq):
            return kernels.paged_decode_attention_pair_plain(q, k, v, 1, tb,
                                                             sq)
        return kernel, plain

    def kernel(q, tb, sq, scratch=None):
        return kernels.paged_decode_attention(q, pool, 1, tb, sq,
                                              kv_scales=scales,
                                              scratch=scratch)

    def plain(q, tb, sq):
        return kernels.paged_decode_attention_plain(q, pool, 1, tb, sq,
                                                    kv_scales=scales)
    return kernel, plain


#: (variant, B, H, KH, D): the served heads at B = 1, 4, 64 (Qwen3's
#: G = 2, Orpheus's G = 3, and G = 7 as 4 + 3 heads per CTA), then every
#: head group (G = 1, 2, 4, 8) and head dims below 128 at B=1 (split) and
#: B=64; D=72 over bf16 pools only (1-byte ones need D % 16 == 0)
_DECODE_EDGE_CASES = [
    (variant, B, H, KH, D) for variant in _DECODE_VARIANTS
    for B, H, KH, D in [(B, H, KH, 128) for B in (1, 4, 64)
                        for H, KH in ((16, 8), (24, 8), (28, 4))]
    + [(B, H, KH, D) for B in (1, 64)
       for H, KH in ((8, 8), (16, 8), (16, 4), (16, 2))
       for D in (64, 72, 128) if (H, KH, D) != (16, 8, 128)]
    if D % 16 == 0 or _DECODE_VARIANTS[variant][0] == torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,B,H,KH,D", _DECODE_EDGE_CASES)
def test_decode_kernel_edges_on_card(cuda_device, variant, B, H, KH, D):
    """The page-parallel split-KV decode kernel against its plain version:
    seq_len 1, exactly one page, both sides of a page boundary, sequences
    over several splits (B=1: one CTA per KV head cannot fill the card, so
    the planned split count is > 1), padded rows on scratch page 0; at
    1, 2 and 4 query heads per CTA (G = 8 as two CTAs per KV head) and at
    head dims below 128 (72: bf16 pools only, 1-byte ones need D % 16)."""
    L, page, maxp = 2, 16, 40
    P = B * maxp + 1
    pool, scales = _device_pool(cuda_device, _DECODE_VARIANTS[variant][0], L,
                                P, page, KH, D, 20 + B + D)
    kernel, plain = _decode_fns(variant, pool, scales)
    g = torch.Generator().manual_seed(20 + B)
    lens = [1, 16, 17, 32, 33, 500, maxp * page]
    if B == 1:
        cases = [[n] for n in lens]
    else:
        cases = [[lens[(i + j) % len(lens)] for i in range(B)]
                 for j in range(2)]
    perm = torch.randperm(P - 1, generator=g).to(torch.int32) + 1
    for seqs in cases:
        seq = torch.tensor(seqs, dtype=torch.int32)
        tables = perm[:B * maxp].reshape(B, maxp).clone()
        if B > 1:
            seq[1] = 1
            tables[1] = 0  # a padded row: seq_len 1 on scratch page 0
        q = torch.randn((B, H, D), generator=g).bfloat16().to(cuda_device)
        tb, sq = tables.to(cuda_device), seq.to(cuda_device)
        out, ref = kernel(q, tb, sq), plain(q, tb, sq)
        assert torch.isfinite(out.float()).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err < CARD_TOL, (seqs, err)
    if B == 1:
        groups = kernels.decode_head_groups(H, KH)
        assert kernels.plan_decode_splits(1, KH, maxp, head_groups=groups) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(_DECODE_VARIANTS))
def test_decode_scratch_shared_across_shapes_on_card(cuda_device, variant):
    """One ``DecodeScratch`` sized for (64 rows, 40 pages) serves launches
    of growing and shrinking batch and table width back to back, eager and
    replayed from a CUDA graph captured before them; one sized too small
    raises before launching; without one, each split launch (captured
    ones too) gets its own."""
    H, KH, D, L, page, maxp = 16, 8, 128, 2, 16, 40
    P = 64 * maxp + 1
    pool, scales = _device_pool(cuda_device, _DECODE_VARIANTS[variant][0], L,
                                P, page, KH, D, 50)
    g = torch.Generator().manual_seed(51)
    perm = torch.randperm(P - 1, generator=g).to(torch.int32) + 1

    def case(B, width):
        seq = torch.randint(1, width * page + 1, (B,), generator=g,
                            dtype=torch.int32)
        seq[0] = width * page
        tables = perm[:B * width].reshape(B, width).contiguous()
        q = torch.randn((B, H, D), generator=g).bfloat16()
        return q.to(cuda_device), tables.to(cuda_device), seq.to(cuda_device)

    def check(out, ref):
        assert torch.isfinite(out.float()).all()
        assert (out.float() - ref.float()).abs().max().item() < CARD_TOL

    kernel, plain = _decode_fns(variant, pool, scales)
    scratch = kernels.DecodeScratch(cuda_device, 64, H, KH, D, maxp)
    cap = case(1, maxp)  # 8 splits: the most states per row
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*cap, scratch=scratch)
        kernel(*cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = kernel(*cap, scratch=scratch)
        g_own = kernel(*cap)
    for B, width in ((1, 3), (4, 8), (64, 40), (2, 40), (1, 40), (8, 12),
                     (4, 2), (64, 1)):
        q, tb, sq = case(B, width)
        ref = plain(q, tb, sq)
        check(kernel(q, tb, sq, scratch=scratch), ref)
        check(kernel(q, tb, sq), ref)
    graph.replay()
    ref = plain(*cap)
    check(g_out, ref)
    check(g_own, ref)
    torch.cuda.synchronize()
    assert int(scratch.counters.abs().sum()) == 0  # left ready
    small = kernels.DecodeScratch(cuda_device, 1, H, KH, D, 4)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="too small"):
        kernel(*cap, scratch=small)
    assert kernels.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH", [(8, 8), (16, 8), (16, 4), (16, 2),
                                  (24, 8), (28, 4), (32, 2)])
@pytest.mark.parametrize("T,segs", [
    (5, (5,)),                 # shorter than one query tile
    (168, (42, 42, 42, 42)),   # the served prefill, edges inside tiles
    (300, (100, 1, 1, 150)),   # single-token segments; T not a multiple
    (200, (70, 60)),           # an all-padding tail of 70 rows
    (1024, (300, 200, 250, 270)),
])
def test_k3_kernel_gqa_and_edges_on_card(cuda_device, H, KH, T, segs):
    q, k, v, seg = _prefill_case(30 + T, T, H, KH, 128, segs)
    args = [x.bfloat16().to(cuda_device) for x in (q, k, v)]
    args.append(seg.to(cuda_device))
    out = kernels.ragged_prefill_attention(*args)
    ref = kernels.ragged_prefill_attention_plain(*args)
    valid = (seg >= 0).to(cuda_device)
    err = (out[valid].float() - ref[valid].float()).abs().max().item()
    assert err < CARD_TOL, err
    assert torch.isfinite(out.float()).all()
    assert torch.count_nonzero(out[~valid]) == 0  # padding rows: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72])
def test_k3_kernel_narrow_heads_on_card(cuda_device, D):
    q, k, v, seg = _prefill_case(40 + D, 150, 16, 8, D, (60, 90))
    args = [x.bfloat16().to(cuda_device) for x in (q, k, v)]
    args.append(seg.to(cuda_device))
    out = kernels.ragged_prefill_attention(*args)
    ref = kernels.ragged_prefill_attention_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() < CARD_TOL


@pytest.mark.parametrize("H,KH,D,max_group,ok", [
    (16, 8, 128, 8, True), (16, 8, 16, 32, True), (12, 8, 128, 8, False),
    (24, 8, 128, 32, True), (28, 4, 128, 32, True), (64, 1, 128, 32, False),
    (16, 8, 256, 8, False), (16, 8, 100, 8, False),
])
def test_kernel_shape_limits_are_checked_before_launch(H, KH, D, max_group,
                                                       ok):
    if ok:
        kernels._check_heads(H, KH, D, max_group)
    else:
        with pytest.raises(ValueError):
            kernels._check_heads(H, KH, D, max_group)
