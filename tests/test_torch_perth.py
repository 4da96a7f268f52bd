"""Port parity, the Perth watermark (vox_serve_tpu_torch/watermark/perth.py
and its branch of ``spectral.apply_watermark``) against the JAX package's,
on the CPU in float32, with the port's random PerthNet weights (at the
published widths: 128 subband bins, 256 channels) in both:

* the STFT: the normalized magnitude within 1e-5 on bins above 1e-3 of
  the peak (~145) and within 1e-3 (0.2 dB) on all (a bin 60 dB down
  carries the float32 FFT's rounding of the peak into its log), the
  complex spectrum it and the phase give within 1e-3; the iSTFT of the
  same magnitude and phase within 1e-5;
* ``perth_encode_mag`` within 1e-4, ``perth_decode_mag`` (its 0.75x, 1x
  and 1.25x branches) within 1e-4, ``perth_encode_wav`` within 1e-4;
* the "perth" branch of ``apply_watermark`` over (2, 21120) at 24 kHz (one
  Chatterbox chunk per row: the 24 -> 32 kHz resample, the mark, the
  resample back, the length kept) within 1e-4 absolute plus 1e-4
  relative (the random mark lifts the peak from 0.48 to ~17);
* ``load_perth_params`` on the exporter's ``perth_net_250000.pth.tar``,
  through ``VOX_SERVE_PERTH_CKPT`` and through a resemble-ai/perth
  snapshot in the hub cache, leaf for leaf against JAX's
  ``_try_load_real_perth``; ``init_watermarker``'s "perth" style serves
  it, and without a checkpoint falls back to the dev spectral marker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from test_torch_chatterbox_cond import flat
from vox_serve_tpu.watermark import perth as jperth
from vox_serve_tpu.watermark import spectral as jspec
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.watermark import perth as tperth
from vox_serve_tpu_torch.watermark import spectral as tspec

torch.set_num_threads(1)

CFG = tperth.PerthConfig()
JCFG = jperth.PerthConfig()
TOL = 1e-4


@pytest.fixture(scope="module")
def perth():
    tp = tperth.init_perth_params(CFG, torch.Generator().manual_seed(1),
                                  "cpu")
    g = torch.Generator().manual_seed(2)
    for conv in tparams.tree_leaves(tp):  # non-zero biases
        if conv.ndim == 1:
            conv.copy_(0.05 * torch.randn(conv.shape, generator=g))
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), tp))
    return tp, jp


def _audio(n, seed=0, rows=2):
    """Voiced-like audio: harmonics under a syllable envelope, a silent
    stretch (so the loudness mask gates part of each row) and a -60 dB
    noise floor. The random weights' mark is ~100 dB where trained
    weights' is inaudible, so the float32 FFT's rounding in bins near the
    1e-9 floor (pure tones) would swing the output by ~1%; no decoded
    chunk is that clean."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 32000.0
    x = np.stack([sum(np.sin(2 * np.pi * k * (120 + 40 * r) * t) / k
                      for k in range(1, 6)) for r in range(rows)])
    x *= 0.3 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) ** 2
    x[:, n // 3: n // 2] = 0.0
    return (x + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32)


def test_config_matches_jax():
    assert (CFG.bins, CFG.subband, CFG.min_level_db) == (
        JCFG.bins, JCFG.subband, JCFG.min_level_db) == (1025, 128, -180.0)


def test_stft_and_istft_match_jax():
    x = _audio(28160)
    tm, tph = tperth.perth_stft(CFG, torch.from_numpy(x))
    jm, jph = jperth.perth_stft(JCFG, jnp.asarray(x))
    assert tm.shape == (2, 1025, 89)
    mag = 10.0 ** ((np.asarray(jm, np.float64) * 195.0 - 180.0) / 20.0)
    loud = mag > 1e-3 * mag.max()
    np.testing.assert_allclose(tm.numpy()[loud], np.asarray(jm)[loud],
                               atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3)
    # the phase of near-silent bins is arbitrary: hold the spectrum
    spec_t = mag * np.exp(1j * tph.numpy().astype(np.float64))
    spec_j = mag * np.exp(1j * np.asarray(jph, np.float64))
    assert np.abs(spec_j).max() > 100
    np.testing.assert_allclose(spec_t, spec_j, atol=1e-3)
    got = tperth.perth_istft(CFG, torch.from_numpy(np.asarray(jm)),
                             torch.from_numpy(np.asarray(jph)), 28160)
    ref = jperth.perth_istft(JCFG, jm, jph, 28160)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-4)  # a round trip


def test_encode_and_decode_mag_match_jax(perth):
    tp, jp = perth
    mag = np.asarray(jperth.perth_stft(JCFG, jnp.asarray(_audio(28160)))[0])
    got = tperth.perth_encode_mag(tp, CFG, torch.from_numpy(mag))
    ref = jperth.perth_encode_mag(jp, JCFG, jnp.asarray(mag))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_array_equal(got[:, 128:].numpy(), mag[:, 128:])
    assert np.abs(got[:, :128].numpy() - mag[:, :128]).max() > 1e-2
    for T in (89, 61, 4):  # the 1.25x / 0.75x branches at odd lengths
        m = np.ascontiguousarray(mag[..., :T])
        got = tperth.perth_decode_mag(tp, CFG, torch.from_numpy(m))
        ref = jperth.perth_decode_mag(jp, JCFG, jnp.asarray(m))
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_encode_wav_and_get_watermark_match_jax(perth):
    tp, jp = perth
    x = _audio(28160, seed=1)
    got = tperth.perth_encode_wav(tp, CFG, torch.from_numpy(x))
    ref = jperth.perth_encode_wav(jp, JCFG, jnp.asarray(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert np.abs(got.numpy() - x).max() > 1e-3  # it marked something
    got = tperth.perth_get_watermark(tp, CFG, got)
    ref = jperth.perth_get_watermark(jp, JCFG, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_apply_watermark_perth_branch_matches_jax(perth):
    tp, jp = perth
    x = _audio(21120, seed=2)
    got = tspec.apply_watermark({"perth": tp, "_perth_cfg": CFG},
                                tspec.WatermarkConfig(style="perth"),
                                torch.from_numpy(x))
    ref = jspec.apply_watermark({"perth": jp, "_perth_cfg": JCFG},
                                jspec.WatermarkConfig(style="perth"),
                                jnp.asarray(x))
    assert got.shape == ref.shape == (2, 21120)
    # the random mark lifts the chunk's peak ~36x: relative as well
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert tspec.watermark_kind({"perth": tp}) == "perth"


def _assert_same_tree(got, ref):
    fg, fr = flat(got), flat(ref)
    assert set(fg) == set(fr) and len(fg) == 56
    for k, v in fg.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, fr[k])


def test_loader_reads_the_exporters_checkpoint(perth, tmp_path,
                                               monkeypatch):
    tp, _ = perth
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    n = synth.write_perth(ckpt, tp)
    assert n > 0
    path = ckpt / "perth_net_250000.pth.tar"
    assert set(torch.load(path, weights_only=False)) == {"model"}
    monkeypatch.delenv("VOX_SERVE_PERTH_CKPT", raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    wcfg = tspec.WatermarkConfig(style="perth")
    assert tspec._try_load_real_perth(wcfg, "cpu") is None
    fallback = tspec.init_watermarker(wcfg, torch.Generator(), "cpu")
    assert tspec.watermark_kind(fallback) == "spectral"
    # through the environment variable (JAX's loader beside it), then
    # through the hub cache (which the JAX package reads at import)
    monkeypatch.setenv("VOX_SERVE_PERTH_CKPT", str(path))
    got = tspec.init_watermarker(wcfg, torch.Generator(), "cpu")
    ref = jspec._try_load_real_perth(jspec.WatermarkConfig(style="perth"))
    assert tspec.watermark_kind(got) == "perth"
    assert got["_perth_cfg"] == CFG
    _assert_same_tree(got["perth"], ref["perth"])
    _assert_same_tree(got["perth"], tp)
    monkeypatch.delenv("VOX_SERVE_PERTH_CKPT")
    hub = tmp_path / "hub"
    synth.write_perth(synth.snapshot_dir(hub, "resemble-ai/perth"), tp)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    got = tspec.init_watermarker(wcfg, torch.Generator(), "cpu")
    assert tspec.watermark_kind(got) == "perth"
    _assert_same_tree(got["perth"], ref["perth"])
