"""Port parity of the SNAC decoder (vox_serve_tpu_torch/codecs/snac.py and
the ``snake`` / ``conv_transpose1d`` layers it runs on) with the JAX
package's, on the CPU.

* ``snake`` (alpha (C,) and (1, C, 1), float32 and bf16) and
  ``conv_transpose1d`` with ``output_padding`` at strides 2, 4 and 8
  against JAX at 1e-5;
* ``snac_decode`` at the small SNAC of the JAX package's Orpheus test
  (decoder 64, latent 32, rates 8/8/4/2) from the same weights, float32,
  at 1e-5 of max |ref|;
* the port's SNAC in bf16 against JAX's SNAC in bf16, each held against
  the JAX float32 output: the port's max error at most 1.25x JAX's plus
  2^-9 of max |f32 output|;
* ``load_snac_params`` (weight-norm as parametrizations, as weight_g /
  weight_v, and plain) and ``load_dac_params`` on synthetic state dicts,
  against the JAX package's mappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.codecs import layers as jlayers
from vox_serve_tpu.codecs import snac as jsnac
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import layers as tlayers
from vox_serve_tpu_torch.codecs import snac as tsnac

torch.set_num_threads(1)

SMALL = dict(decoder_dim=64, decoder_rates=(8, 8, 4, 2), latent_dim=32,
             codebook_size=4096, codebook_dim=8, vq_strides=(4, 2, 1),
             depthwise=True)
TOL = 1e-5
BF16_FACTOR, BF16_SLACK = 1.25, 2.0 ** -9


def _np_tree(tree):
    return tparams.tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha_shape", ["flat", "nch"])
def test_snake_matches_jax(dtype, alpha_shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 50)) * 3).astype(np.float32)
    alpha = rng.uniform(0.05, 2.0, 16).astype(np.float32)
    if alpha_shape == "nch":
        alpha = alpha[None, :, None]
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jlayers.snake(jx, jnp.asarray(alpha)).astype(
        jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tlayers.snake(tx, torch.from_numpy(alpha))
    assert got.dtype == tx.dtype
    tol = TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("output_padding", [0, 1])
def test_conv_transpose1d_output_padding_matches_jax(stride, output_padding):
    rng = np.random.default_rng(stride)
    c_in, c_out, k, T = 12, 6, 2 * stride, 9
    p = {"w": rng.uniform(-0.3, 0.3, (c_in, c_out, k)).astype(np.float32),
         "b": rng.uniform(-0.3, 0.3, (c_out,)).astype(np.float32)}
    x = rng.standard_normal((2, c_in, T)).astype(np.float32)
    kw = dict(stride=stride, padding=-(-stride // 2),
              output_padding=output_padding)
    ref = np.asarray(jlayers.conv_transpose1d(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw))
    got = tlayers.conv_transpose1d(tparams.tree_to_torch(p, "cpu"),
                                   torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape
    assert got.shape[-1] == (T - 1) * stride - 2 * kw["padding"] + k \
        + output_padding
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def small_snac():
    """The port's random SNAC at the small widths, and the same weights as
    a numpy tree."""
    cfg = tsnac.SNACConfig(**SMALL)
    params = tsnac.init_snac_decoder(cfg, torch.Generator().manual_seed(7),
                                     "cpu")
    return cfg, params, _np_tree(params)


def _codes(B, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4096, (B, n)).astype(np.int32)
            for n in (4, 8, 16)]


def _jax_decode(np_params, codes, dtype=jnp.float32):
    cfg = jsnac.SNACConfig(**SMALL)
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), np_params)
    out = jax.jit(lambda p, c: jsnac.snac_decode(p, cfg, c))(
        p, [jnp.asarray(c) for c in codes])
    return np.asarray(out.astype(jnp.float32))


def test_snac_tree_has_the_jax_shapes(small_snac):
    _, _, np_params = small_snac
    ref = jsnac.init_snac_decoder(jsnac.SNACConfig(**SMALL),
                                  jax.random.key(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda a: tuple(a.shape), np_params) == shapes


def test_snac_decode_matches_jax(small_snac):
    cfg, params, np_params = small_snac
    codes = _codes(3, 2)
    ref = _jax_decode(np_params, codes)
    got = tsnac.snac_decode(params, cfg,
                            [torch.from_numpy(c) for c in codes]).numpy()
    assert got.shape == (3, 1, 16 * cfg.hop_per_latent)
    assert np.all(np.abs(got) <= 1.0)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale


def test_snac_bf16_is_as_close_to_f32_as_jax_bf16(small_snac):
    cfg, params, np_params = small_snac
    codes = _codes(2, 3)
    f32 = _jax_decode(np_params, codes)
    jb = _jax_decode(np_params, codes, jnp.bfloat16)
    p16 = tparams.tree_map(lambda t: t.to(torch.bfloat16), params)
    tb = tsnac.snac_decode(p16, cfg, [torch.from_numpy(c) for c in codes])
    assert tb.dtype == torch.bfloat16
    tb = tb.float().numpy()
    assert np.isfinite(tb).all()
    scale = np.abs(f32).max()
    err_jax = np.abs(jb - f32).max()
    err_port = np.abs(tb - f32).max()
    assert 0 < err_jax  # bf16 does round
    assert err_port <= BF16_FACTOR * err_jax + BF16_SLACK * scale


# ---------------------------------------------------------------------------
# checkpoint mappers on synthetic state dicts
# ---------------------------------------------------------------------------


def _snac_state_dict(cfg, seed):
    """A state dict in the snac_24khz layout at cfg's widths: each conv
    under one of the three weight forms in turn."""
    rng = np.random.default_rng(seed)
    sd, n = {}, [0]

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def conv(name, o, i, k, bias=True):
        form = n[0] % 3
        n[0] += 1
        if form == 0:
            sd[f"{name}.parametrizations.weight.original0"] = arr(o, 1, 1)
            sd[f"{name}.parametrizations.weight.original1"] = arr(o, i, k)
        elif form == 1:
            sd[f"{name}.weight_g"] = arr(o, 1, 1)
            sd[f"{name}.weight_v"] = arr(o, i, k)
        else:
            sd[f"{name}.weight"] = arr(o, i, k)
        if bias:
            sd[f"{name}.bias"] = arr(o)

    for q in range(len(cfg.vq_strides)):
        sd[f"quantizer.quantizers.{q}.codebook.weight"] = arr(
            cfg.codebook_size, cfg.codebook_dim)
        conv(f"quantizer.quantizers.{q}.out_proj", cfg.latent_dim,
             cfg.codebook_dim, 1)
    d, ch = "decoder.model", cfg.decoder_dim
    conv(f"{d}.0", cfg.latent_dim, 1, 7)
    conv(f"{d}.1", ch, cfg.latent_dim, 1)
    base = 2
    for i, s in enumerate(cfg.decoder_rates):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        pre = f"{d}.{base + i}.block"
        sd[f"{pre}.0.alpha"] = arr(1, cin, 1)
        # ConvTranspose: (in, out, k), bias over out
        conv(f"{pre}.1", cin, cout, 2 * s, bias=False)
        sd[f"{pre}.1.bias"] = arr(cout)
        conv(f"{pre}.2.linear", cout, cout, 1, bias=False)
        for j in range(3):
            rp = f"{pre}.{3 + j}.block"
            sd[f"{rp}.0.alpha"] = arr(1, cout, 1)
            conv(f"{rp}.1", cout, 1, 7)
            sd[f"{rp}.2.alpha"] = arr(1, cout, 1)
            conv(f"{rp}.3", cout, cout, 1)
    m = base + len(cfg.decoder_rates)
    sd[f"{d}.{m}.alpha"] = arr(1, ch // 2 ** len(cfg.decoder_rates), 1)
    conv(f"{d}.{m + 1}", 1, ch // 2 ** len(cfg.decoder_rates), 7)
    return sd


def _dac_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    sd = {}

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = arr(o, i, k)
        sd[f"{name}.bias"] = arr(o)

    for q in range(len(cfg.vq_strides)):
        sd[f"quantizer.quantizers.{q}.codebook.weight"] = arr(
            cfg.codebook_size, cfg.codebook_dim)
        conv(f"quantizer.quantizers.{q}.out_proj", cfg.latent_dim,
             cfg.codebook_dim, 1)
    ch = cfg.decoder_dim
    conv("decoder.conv1", ch, cfg.latent_dim, 7)
    for i, s in enumerate(cfg.decoder_rates):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        pre = f"decoder.block.{i}"
        sd[f"{pre}.snake1.alpha"] = arr(1, cin, 1)
        sd[f"{pre}.conv_t1.weight"] = arr(cin, cout, 2 * s)
        sd[f"{pre}.conv_t1.bias"] = arr(cout)
        for j in (1, 2, 3):
            rp = f"{pre}.res_unit{j}"
            sd[f"{rp}.snake1.alpha"] = arr(1, cout, 1)
            conv(f"{rp}.conv1", cout, cout, 7)
            sd[f"{rp}.snake2.alpha"] = arr(1, cout, 1)
            conv(f"{rp}.conv2", cout, cout, 1)
    out = ch // 2 ** len(cfg.decoder_rates)
    sd["decoder.snake1.alpha"] = arr(1, out, 1)
    conv("decoder.conv2", 1, out, 7)
    return sd


def _assert_trees_equal(got, ref):
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prefix", ["", "snac."])
def test_load_snac_params_matches_jax(prefix):
    kw = dict(SMALL)
    cfg_t, cfg_j = tsnac.SNACConfig(**kw), jsnac.SNACConfig(**kw)
    sd = {prefix + k: v for k, v in _snac_state_dict(cfg_t, 5).items()}
    got = tsnac.load_snac_params(sd, cfg_t, prefix)
    _assert_trees_equal(got, jsnac.load_snac_params(sd, cfg_j, prefix))
    # the mapped tree decodes in the port
    p = tparams.tree_to_torch(got, "cpu")
    out = tsnac.snac_decode(p, cfg_t, [torch.from_numpy(c)
                                       for c in _codes(1, 4)])
    assert torch.isfinite(out).all()


def test_load_dac_params_matches_jax():
    kw = dict(SMALL, depthwise=False, noise=False)
    cfg_t, cfg_j = tsnac.SNACConfig(**kw), jsnac.SNACConfig(**kw)
    sd = _dac_state_dict(cfg_t, 6)
    _assert_trees_equal(tsnac.load_dac_params(sd, cfg_t),
                        jsnac.load_dac_params(sd, cfg_j))
