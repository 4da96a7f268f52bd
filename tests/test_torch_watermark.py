"""Port parity, the watermark (vox_serve_tpu_torch/watermark/) against the
JAX package's, on the CPU: the dev spectral marker the worker serves
without the published weights, and the SilentCipher math (random
``init_silentcipher`` params converted by ``tree_to_torch``, the message
band cut to 512 rows as in the JAX package's own parity test), audio from
numpy seeds.

Tolerances:
- ``_message_pattern`` and ``message_to_symbols``: bit-equal;
- ``apply_watermark`` (spectral) at (2, 19200): 1e-6 absolute (float32
  FFTs in another order; measured ~2e-7 on audio of peak ~0.9);
  ``detect_watermark``: 1e-5 absolute;
- ``sinc_resample``: 1e-6 absolute (measured ~2e-7);
- ``sc_encode``: 1e-5 of max |reference| (measured ~3e-7); the symbols
  ``sc_decode_symbols`` reads back: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.watermark import silentcipher as jsc
from vox_serve_tpu.watermark import spectral as jspec
from vox_serve_tpu_torch.params import tree_map, tree_to_torch
from vox_serve_tpu_torch.watermark import (SILENTCIPHER_KEY, WatermarkConfig,
                                           apply_watermark, detect_watermark,
                                           init_watermarker, watermark_kind)
from vox_serve_tpu_torch.watermark import silentcipher as tsc
from vox_serve_tpu_torch.watermark import spectral as tspec

torch.set_num_threads(1)

SC = dict(message_band_size=512)


def _audio(B=2, T=19200, seed=0, amp=0.2):
    return (np.random.default_rng(seed).standard_normal((B, T)) * amp
            ).astype(np.float32)


@pytest.fixture(scope="module")
def spectral():
    cfg = jspec.WatermarkConfig()
    jp = jspec.init_watermarker(cfg, jax.random.key(0))
    return cfg, jp, tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def silentcipher():
    jcfg = jsc.SilentCipherConfig(**SC)
    jp = jax.jit(lambda k: jsc.init_silentcipher(jcfg, k))(jax.random.key(1))
    return jcfg, jp, tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")


def test_config_and_key_match_jax():
    assert SILENTCIPHER_KEY == jspec.SILENTCIPHER_KEY == (11, 91, 60, 147, 209)
    assert WatermarkConfig() == WatermarkConfig(**{
        f: getattr(jspec.WatermarkConfig(), f)
        for f in jspec.WatermarkConfig.__dataclass_fields__})
    assert tsc.SilentCipherConfig(**SC) == tsc.SilentCipherConfig(**{
        f: getattr(jsc.SilentCipherConfig(**SC), f)
        for f in jsc.SilentCipherConfig.__dataclass_fields__})


@pytest.mark.parametrize("n_bins", [129, 513])
@pytest.mark.parametrize("message", [SILENTCIPHER_KEY, (1, 2, 3, 4, 5)])
def test_message_pattern_bit_equal(n_bins, message):
    got = tspec._message_pattern(WatermarkConfig(message=message), n_bins)
    ref = jspec._message_pattern(jspec.WatermarkConfig(message=message),
                                 n_bins)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


def test_init_from_an_explicit_generator():
    """Params on the requested device from the caller's generator: the same
    seed gives the same params; the pattern is the message's."""
    cfg = WatermarkConfig()

    def make(seed):
        return init_watermarker(cfg, torch.Generator().manual_seed(seed),
                                "cpu")

    a, b, c = make(101), make(101), make(7)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "conv1": (16, 1, 5), "conv2": (1, 16, 5), "pattern": (129,)}
    torch.testing.assert_close(a["conv1"], b["conv1"], rtol=0, atol=0)
    assert not torch.equal(a["conv1"], c["conv1"])
    np.testing.assert_array_equal(a["pattern"].numpy(),
                                  tspec._message_pattern(cfg, 129))
    assert watermark_kind(a) == "spectral" and watermark_kind(None) is None
    assert watermark_kind({"sc": {}}) == "silentcipher"


def test_apply_and_detect_match_jax(spectral):
    cfg, jp, tp = spectral
    audio = _audio()
    ref = np.asarray(jspec.apply_watermark(jp, cfg, jnp.asarray(audio)))
    got = apply_watermark(tp, WatermarkConfig(), torch.from_numpy(audio))
    assert got.dtype == torch.float32 and tuple(got.shape) == audio.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    for x in (ref, audio):
        np.testing.assert_allclose(
            detect_watermark(tp, WatermarkConfig(),
                             torch.from_numpy(np.array(x))).numpy(),
            np.asarray(jspec.detect_watermark(jp, cfg, jnp.asarray(x))),
            rtol=0, atol=1e-5)


def test_round_trip_detectable_and_transparent(spectral):
    """The JAX package's round-trip test on the port: a 220 Hz tone keeps
    its shape, stays within 0.05 of the original, and scores above the
    clean audio."""
    _, _, tp = spectral
    cfg = WatermarkConfig()
    t = torch.arange(24000) / 24000.0
    audio = (0.3 * torch.sin(2 * np.pi * 220.0 * t))[None].repeat(2, 1)
    marked = apply_watermark(tp, cfg, audio)
    assert marked.shape == audio.shape
    assert (marked - audio).abs().max() < 0.05
    assert (detect_watermark(tp, cfg, marked)
            > detect_watermark(tp, cfg, audio) + 1e-4).all()


def test_perth_branch_raises(spectral):
    """"perth" parameters select the Perth branch: incomplete ones (no
    ``_perth_cfg``) raise there rather than fall through to the dev
    spectral marker; complete ones mark a chunk at its length
    (tests/test_torch_perth.py holds the values to JAX's)."""
    from vox_serve_tpu_torch.watermark.perth import (PerthConfig,
                                                     init_perth_params)

    with pytest.raises(KeyError, match="_perth_cfg"):
        apply_watermark({"perth": {}}, WatermarkConfig(style="perth"),
                        torch.zeros((1, 4096)))
    cfg = PerthConfig()
    p = init_perth_params(cfg, torch.Generator().manual_seed(0), "cpu")
    audio = torch.from_numpy(_audio(T=4096, seed=3)[:1])
    out = apply_watermark({"perth": p, "_perth_cfg": cfg},
                          WatermarkConfig(style="perth"), audio)
    assert out.shape == (1, 4096) and torch.isfinite(out).all()


@pytest.mark.parametrize("rates,out_len", [((24000, 44100), "floor"),
                                           ((44100, 24000), "floor"),
                                           ((24000, 44100), "ceil")])
def test_sinc_resample_matches_jax(rates, out_len):
    x = _audio(T=4801, seed=2)
    ref = np.asarray(jsc.sinc_resample(jnp.asarray(x), *rates,
                                       out_len=out_len))
    got = tsc.sinc_resample(torch.from_numpy(x), *rates, out_len=out_len)
    assert tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    np.testing.assert_array_equal(tsc._resample_filter(147, 80),
                                  jsc._resample_filter(147, 80))


def test_message_to_symbols_equal():
    cfg = tsc.SilentCipherConfig(**SC)
    got = tsc.message_to_symbols(list(SILENTCIPHER_KEY), cfg)
    ref = jsc.message_to_symbols(list(SILENTCIPHER_KEY),
                                 jsc.SilentCipherConfig(**SC))
    assert got.shape == (5, 21) and got.tobytes() == ref.tobytes()


def test_init_silentcipher_shapes_match_jax(silentcipher):
    jcfg, jp, _ = silentcipher
    tp = tsc.init_silentcipher(tsc.SilentCipherConfig(**SC),
                               torch.Generator().manual_seed(0), "cpu")
    shapes = []
    tree_map(lambda a, b: shapes.append((tuple(a.shape), tuple(b.shape))),
             jax.tree.map(np.asarray, jp), tp)
    assert len(shapes) == (3 + 4 + 10) * 8 + 2 * 2
    assert all(a == b for a, b in shapes)


def test_sc_encode_and_decode_match_jax(silentcipher):
    jcfg, jp, tp = silentcipher
    tcfg = tsc.SilentCipherConfig(**SC)
    onehot = jsc.message_to_symbols(list(SILENTCIPHER_KEY), jcfg)
    y = _audio(T=6000, seed=3, amp=0.3)
    ref = np.asarray(jax.jit(lambda p, a, m: jsc.sc_encode(p, jcfg, a, m))(
        jp, jnp.asarray(y), jnp.asarray(onehot)))
    got = tsc.sc_encode(tp, tcfg, torch.from_numpy(y),
                        torch.from_numpy(onehot))
    assert tuple(got.shape) == y.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(
        tsc.sc_decode_symbols(tp, tcfg, got).numpy(),
        np.asarray(jax.jit(lambda p, a: jsc.sc_decode_symbols(p, jcfg, a))(
            jp, jnp.asarray(ref))))


def test_sc_branch_of_apply_watermark(silentcipher):
    """SilentCipher params (as a loaded checkpoint would give them) route a
    24 kHz chunk through the 44.1 kHz model and back, at its length."""
    jcfg, jp, tp = silentcipher
    tcfg = tsc.SilentCipherConfig(**SC)
    onehot = jsc.message_to_symbols(list(SILENTCIPHER_KEY), jcfg)
    audio = _audio(B=1, T=3000, seed=4)
    jparams = {"sc": jp, "sc_msg": jnp.asarray(onehot), "_sc_cfg": jcfg}
    tparams = {"sc": tp, "sc_msg": torch.from_numpy(onehot), "_sc_cfg": tcfg}
    ref = np.asarray(jax.jit(lambda a: jspec.apply_watermark(
        jparams, jspec.WatermarkConfig(), a))(jnp.asarray(audio)))
    got = apply_watermark(tparams, WatermarkConfig(), torch.from_numpy(audio))
    assert tuple(got.shape) == audio.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert watermark_kind(tparams) == "silentcipher"
