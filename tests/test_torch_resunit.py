"""Port parity, the codec's residual-unit stack (K2's path): the port's
``fused_resunit_stack`` (on the CPU, its plain version) against the JAX
package's Pallas stack in interpret mode, whole and streamed with caches;
the wrapper contract; the debug-width Qwen3 codec with
``VOX_FUSED_RESUNIT=1`` against the JAX codec's default (XLA) path; and,
in plain torch, the kernel's arithmetic and plan: its parameter packing
(TF32 hi/lo halves, computed once per parameter set), a 3xTF32 emulation
of a full-width conv1 product against float64, and the tile planner's
coverage at the serving shapes. The kernel itself is held against its
plain version on the card.

Tolerances (float32): stacks rtol 1e-5 (atol 1e-6 near zero crossings),
the same products summed in another order; the codec's waveform 1e-4
absolute, as in ``test_torch_codec.py``; the packed halves 2^-21 relative
(the split keeps 22 significant bits); the 3xTF32 product 1e-5 of max
|ref|, ten times under the kernel's 1e-4 bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.codecs import qwen3_codec as jcodec
from vox_serve_tpu.ops.pallas_resunit import \
    fused_resunit_stack as jfused_resunit_stack
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import qwen3_codec as tcodec
from vox_serve_tpu_torch.ops import resunit

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
DILS = (1, 3, 9)
SMALL = dict(codebook_dim=32, codebook_size=2048, latent_dim=48,
             decoder_dim=64, hidden_size=32, intermediate_size=64,
             head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
             num_quantizers=16, sliding_window=12, upsample_rates=(4, 3),
             upsampling_ratios=(2, 2), vq_dim=16)


def _units(rng, C):
    def conv(k):
        s = 1.0 / np.sqrt(C * k)
        return {"w": rng.uniform(-s, s, (C, C, k)).astype(np.float32),
                "b": rng.uniform(-s, s, (C,)).astype(np.float32)}

    def small():
        return (rng.standard_normal(C) * 0.2).astype(np.float32)

    return [{"alpha1": small(), "beta1": small(), "conv1": conv(7),
             "alpha2": small(), "beta2": small(), "conv2": conv(1)}
            for _ in DILS]


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tparams.tree_to_torch(tree, "cpu", torch.float32))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("C,T", [(16, 128), (96, 64)])
def test_stack_matches_jax_interpret_whole(C, T):
    rng = np.random.default_rng(C)
    ju, tu = _both(_units(rng, C))
    x = (rng.standard_normal((2, C, T)) * 0.5).astype(np.float32)
    ref, jnc = jfused_resunit_stack(jnp.asarray(x), ju, None, interpret=True)
    got, tnc = resunit.fused_resunit_stack(torch.from_numpy(x), tu, None)
    assert jnc == tnc == [None, None, None]
    _close(got, ref)


@pytest.mark.parametrize("C,T", [(16, 120), (96, 128)])
def test_stack_matches_jax_interpret_over_two_streamed_chunks(C, T):
    rng = np.random.default_rng(C + 1)
    ju, tu = _both(_units(rng, C))
    x = (rng.standard_normal((2, C, T)) * 0.5).astype(np.float32)
    caches = [(rng.standard_normal((2, C, 6 * d)) * 0.5).astype(np.float32)
              for d in DILS]
    jc, tc = _both(caches)
    t1 = T // 2
    for sl in (slice(0, t1), slice(t1, T)):
        ref, jc = jfused_resunit_stack(jnp.asarray(x[..., sl]), ju, jc,
                                       interpret=True)
        got, tc = resunit.fused_resunit_stack(torch.from_numpy(x[..., sl]),
                                              tu, tc)
        _close(got, ref)
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == b.shape
            _close(a, b)


def test_short_chunks_and_other_stacks_raise_in_both():
    rng = np.random.default_rng(3)
    ju, tu = _both(_units(rng, 16))
    x = np.zeros((1, 16, 54), np.float32)
    with pytest.raises(ValueError):
        jfused_resunit_stack(jnp.asarray(x), ju, None, interpret=True)
    with pytest.raises(ValueError):
        resunit.fused_resunit_stack(torch.from_numpy(x), tu, None)
    x = np.zeros((1, 16, 80), np.float32)
    with pytest.raises(ValueError):
        jfused_resunit_stack(jnp.asarray(x), ju[:2], None, dilations=(1, 3),
                             interpret=True)
    with pytest.raises(ValueError):
        resunit.fused_resunit_stack(torch.from_numpy(x), tu[:2], None,
                                    dilations=(1, 3))


def test_snake_constants():
    a = torch.tensor([0.0, 0.5, -1.0])
    b = torch.tensor([0.0, -2.0, 1.0])
    af, binv = resunit.snake_constants(a, b)
    torch.testing.assert_close(af, torch.exp(a))
    torch.testing.assert_close(binv, 1.0 / (torch.exp(b) + 1e-9))


def test_codec_with_fused_resunit_matches_jax_xla_path(monkeypatch):
    """Chunks of 1, 2 and 4 frames: the first keeps every block at T <= 54
    (plain chain), the second splits (32 plain, 96 fused), the third fuses
    both blocks (64, 192)."""
    rng = np.random.default_rng(4)
    jcfg = jcodec.Qwen3CodecConfig(**SMALL)
    tcfg = tcodec.Qwen3CodecConfig(**SMALL)
    params = jax.tree.map(np.asarray, jcodec.init_qwen3_codec(
        jcfg, jax.random.key(9)))
    for blk in params["decoder"]["blocks"]:  # non-trivial snake constants
        for u in blk["res"]:
            for key in ("alpha1", "beta1", "alpha2", "beta2"):
                u[key] = (rng.standard_normal(u[key].shape) * 0.2).astype(
                    np.float32)
    jp, tp = _both(params)
    codes = rng.integers(0, 2048, (2, 16, 7)).astype(np.int32)
    spans = [(0, 1), (1, 2), (3, 4)]

    monkeypatch.delenv("VOX_FUSED_RESUNIT", raising=False)
    jcache = jcodec.qwen3_codec_init_cache(jcfg, 2)
    jchunk = jax.jit(jcodec.qwen3_codec_decode_chunk, static_argnums=1)
    refs = []
    for s, n in spans:
        jw, jcache = jchunk(jp, jcfg, jnp.asarray(codes[:, :, s:s + n]),
                            jcache)
        refs.append(np.asarray(jw))

    monkeypatch.setenv("VOX_FUSED_RESUNIT", "1")
    seen = []
    real = tcodec.fused_resunit_stack

    def spy(x, *args):
        seen.append(x.shape[-1])
        return real(x, *args)

    monkeypatch.setattr(tcodec, "fused_resunit_stack", spy)
    tcache = tcodec.qwen3_codec_init_cache(tcfg, 2, "cpu")
    for (s, n), ref in zip(spans, refs):
        tw, tcache = tcodec.qwen3_codec_decode_chunk(
            tp, tcfg, torch.from_numpy(codes[:, :, s:s + n]), tcache)
        np.testing.assert_allclose(tw.numpy(), ref, atol=1e-4)
    assert seen == [96, 64, 192]
    for tb, jb in zip(tcache["dec_blocks"], jcache["dec_blocks"]):
        for a, b in zip(tb["res"], jb["res"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_packed_halves_restore_the_weights_and_pack_once():
    g = torch.Generator().manual_seed(7)
    units = tparams.tree_to_torch(_units(np.random.default_rng(7), 24),
                                  "cpu", torch.float32)
    p = units[0]
    before = resunit.pack_unit.count
    pk = resunit.pack_unit(p)
    assert resunit.pack_unit.count == before + 1
    for packed, w, taps in ((pk.w1, p["conv1"]["w"], 7),
                            (pk.w2, p["conv2"]["w"], 1)):
        assert tuple(packed.shape) == (2, taps, 6, 24, 4)
        assert packed.is_contiguous()
        # both halves are TF32 values: the low 13 mantissa bits are zero
        assert not (packed.view(torch.int32) & 0x1FFF).any()
        # (half, k, C_in/4, C_out, 4) -> (half, C_out, C_in, k): element
        # [h, j, c, o, i] is plane h of W[o, 4c + i, j]
        halves = packed.permute(0, 3, 2, 4, 1).reshape(2, 24, 24, taps)
        hi, lo = resunit.split_tf32(w)
        torch.testing.assert_close(halves[0], hi, rtol=0, atol=0)
        torch.testing.assert_close(halves[1], lo, rtol=0, atol=0)
        err = (halves[0] + halves[1] - w).abs()
        assert (err <= 2.0 ** -21 * w.abs()).all()
    torch.testing.assert_close(pk.b1, p["conv1"]["b"], rtol=0, atol=0)
    af, binv = resunit.snake_constants(p["alpha2"], p["beta2"])
    torch.testing.assert_close(pk.af2, af, rtol=0, atol=0)
    torch.testing.assert_close(pk.bi2, binv, rtol=0, atol=0)
    # repeated calls reuse the packing; an in-place change repacks
    for _ in range(3):
        assert resunit.pack_unit(p) is pk
    assert resunit.pack_unit.count == before + 1
    p["conv1"]["w"].mul_(torch.rand((), generator=g) + 0.5)
    assert resunit.pack_unit(p) is not pk
    assert resunit.pack_unit.count == before + 2


def test_3xtf32_split_product_matches_float32_at_full_width():
    """One C=768 conv1 as the kernel computes it (K = 7 taps x 768
    channels, snaked input, weights at the conv's init scale): hi/lo split
    operands, hi*hi + hi*lo + lo*hi accumulated in float32 (TF32 products
    are exact in float32), against the float64 product."""
    C, M = 768, 32
    K = 7 * C
    g = torch.Generator().manual_seed(8)
    x = torch.randn((M, K), generator=g) * 0.5
    a = x + 0.8 * torch.sin(1.2 * x) ** 2
    s = 1.0 / np.sqrt(K)
    w = (torch.rand((K, C), generator=g) * 2 - 1) * s
    ref = a.double() @ w.double()
    scale = ref.abs().max().item()
    ah, al = resunit.split_tf32(a)
    wh, wl = resunit.split_tf32(w)
    three = al @ wh + ah @ wl + ah @ wh
    single = resunit.tf32_round(a) @ resunit.tf32_round(w)
    err3 = (three.double() - ref).abs().max().item() / scale
    err1 = (single.double() - ref).abs().max().item() / scale
    err32 = ((a @ w).double() - ref).abs().max().item() / scale
    assert err3 < 1e-5
    assert err3 < 4 * err32 + 1e-7  # as close as a float32 product
    assert err1 > 30 * err3  # one TF32 pass alone would not be


#: the decoder blocks of a 10-frame detokenize at B=1 and B=4, with the
#: tile the planner gives each on a 132-SM card: the fastest of the four
#: tiles at each shape in graph-replayed timings on an H100
SERVING_PLANS = {
    (4, 768, 320): (64, 64), (4, 384, 1600): (128, 64),
    (4, 192, 6400): (128, 64), (4, 96, 19200): (128, 32),
    (1, 768, 320): (64, 32), (1, 384, 1600): (128, 64),
    (1, 192, 6400): (128, 64), (1, 96, 19200): (128, 32),
}


@pytest.mark.parametrize("B,C,T", list(SERVING_PLANS))
def test_tile_plan_covers_every_row_and_channel_once(B, C, T):
    """The planned grid of (time tile, channel tile, batch row) CTAs covers
    every (row, channel) of the block exactly once, with a tile the kernel
    is compiled for, no padded channel tile, and the planner's cost model
    choosing what it chose on the card (NVIDIA H100, 132 SMs)."""
    bm, bn = resunit.plan_tiles(B, C, T, 132)
    assert (bm, bn) == SERVING_PLANS[(B, C, T)]
    assert bm in resunit.TILE_M and bn in resunit.TILE_N
    assert C % bn == 0
    seen = torch.zeros((B, T, C), dtype=torch.int32)
    grid = (-(-T // bm), -(-C // bn), B)
    for b in range(grid[2]):
        for n in range(grid[1]):
            for m in range(grid[0]):
                seen[b, m * bm:(m + 1) * bm, n * bn:(n + 1) * bn] += 1
    assert seen.min().item() == 1 and seen.max().item() == 1


def test_tile_plan_fills_small_grids_and_prefers_tall_tiles():
    # one stream at the widest block: 64 x 32 tiles put a CTA on 120 SMs,
    # where 128 x 64 tiles would leave all but 36 idle
    assert resunit.plan_tiles(1, 768, 320, 132) == (64, 32)
    # a grid far larger than the card: the tallest, widest tile stages the
    # fewest bytes per output
    assert resunit.plan_tiles(64, 384, 1600, 132) == (128, 64)
    # any C % 8 == 0 gets a tile, padded where no compiled width divides it
    assert resunit.plan_tiles(1, 16, 55, 132)[1] == 32
    assert resunit.plan_tiles(1, 24, 55, 132)[1] == 32
