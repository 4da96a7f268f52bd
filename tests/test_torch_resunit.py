"""Port parity, the codec's residual-unit stack (K2's path): the port's
``fused_resunit_stack`` (on the CPU, its plain version) against the JAX
package's Pallas stack in interpret mode, whole and streamed with caches;
the wrapper contract; and the debug-width Qwen3 codec with
``VOX_FUSED_RESUNIT=1`` against the JAX codec's default (XLA) path. The
kernel itself is held against its plain version on the card.

Tolerances (float32): stacks rtol 1e-5 (atol 1e-6 near zero crossings),
the same products summed in another order; the codec's waveform 1e-4
absolute, as in ``test_torch_codec.py``.
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
