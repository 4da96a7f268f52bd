"""Port parity, the HiFT vocoder (vox_serve_tpu_torch/codecs/hifigan.py)
against the JAX package's vox_serve_tpu/codecs/hifigan.py, on the CPU in
float32 at the JAX CosyVoice2 test's small widths (``SMALL_HIFT``), with the
same weights in both packages and mel inputs from numpy seeds.

Tolerances, relative to max |ref| of each output:
* the F0 head, the STFT of a given source and the inverse STFT: 1e-5;
* the sine source: 1e-3. It integrates its phase with a float32 cumsum
  over every sample (6,720 at 14 frames), summed in another order in each
  package, so its phase drifts with the length (measured: 6e-5 at 12
  frames, 3.4e-4 at 40);
* ``hift_decode``: 1e-5 with a fixed ``source_cache`` covering the whole
  source, 1e-4 with the free source (its drift, damped by the trunk);
  ``hift_decode_chunk`` over three chunks, each with the cache the one
  before left: the waves and the caches' mel / speech tails 1e-4, the
  cached source 1e-3;
* ``load_hift_params`` on the exporter's ``hift.pt`` state dict (weight-norm
  pairs, the ``generator.`` prefix stripped): every leaf equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_hift
from vox_serve_tpu.codecs import hifigan as jhift
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import hifigan as thift
from vox_serve_tpu_torch.models.backbone import seeded_generator

torch.set_num_threads(1)

SMALL = dict(in_channels=16, base_channels=32, nb_harmonics=4,
             upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
             f0_cond_channels=16)
PART_TOL = 1e-5
SOURCE_TOL = 1e-3
WAVE_FIXED_TOL = 1e-5
WAVE_TOL = 1e-4


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(scope="module")
def pair():
    tcfg, jcfg = thift.HiFTConfig(**SMALL), jhift.HiFTConfig(**SMALL)
    tp = thift.init_hift(tcfg, seeded_generator("cpu", 0), "cpu")
    g = torch.Generator().manual_seed(1)
    # snake alphas away from 1, and an F0 head around 120 Hz, so that the
    # source is voiced
    for r in tp["resblocks"] + tp["source_resblocks"]:
        for k in ("alpha1", "alpha2"):
            r[k] = [a + 0.3 * torch.rand(a.shape, generator=g) for a in r[k]]
    tp["f0_out_w"] = tp["f0_out_w"] * 50.0
    tp["f0_out_b"] = tp["f0_out_b"] + 120.0
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), tp))
    return tcfg, jcfg, tp, jp


def _mel(B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, SMALL["in_channels"], T)).astype(np.float32)


def test_source_and_stft_match_jax(pair):
    tcfg, jcfg, tp, jp = pair
    mel = _mel(2, 14, 0)
    jf0 = jhift._f0_predictor(jp, jnp.asarray(mel))
    tf0 = thift._f0_predictor(tp, torch.from_numpy(mel))
    assert _rel(tf0, jf0) <= PART_TOL
    assert (np.asarray(jf0) > jcfg.nsf_voiced_threshold).mean() > 0.5
    f0 = np.asarray(jf0)
    js = jhift._sine_source(jp, jcfg, jnp.asarray(f0), None)
    ts = thift._sine_source(tp, tcfg, torch.from_numpy(f0))
    assert _rel(ts, js) <= SOURCE_TOL
    s = np.asarray(js)[:, 0]
    assert _rel(thift._stft_18(tcfg, torch.from_numpy(s)),
                jhift._stft_18(jcfg, jnp.asarray(s))) <= PART_TOL
    rng = np.random.default_rng(1)
    mag = rng.random((2, 9, 40)).astype(np.float32) * 3
    ph = rng.standard_normal((2, 9, 40)).astype(np.float32)
    assert _rel(thift._istft(tcfg, torch.from_numpy(mag),
                             torch.from_numpy(ph)),
                jhift._istft(jcfg, jnp.asarray(mag), jnp.asarray(ph))
                ) <= PART_TOL


@pytest.mark.parametrize("fixed_source", [True, False])
def test_hift_decode_matches_jax(pair, fixed_source):
    tcfg, jcfg, tp, jp = pair
    T = 14  # a chunk's 8 frames after the 6 context frames: shared shapes
    mel = _mel(2, T, 2)
    src = None
    if fixed_source:
        src = np.random.default_rng(3).uniform(
            -0.1, 0.1, (2, 1, T * tcfg.total_upsample)).astype(np.float32)
    jw, js = jhift.hift_decode(jp, jcfg, jnp.asarray(mel),
                               None if src is None else jnp.asarray(src))
    tw, ts = thift.hift_decode(tp, tcfg, torch.from_numpy(mel),
                               None if src is None else torch.from_numpy(src))
    assert tuple(tw.shape) == jw.shape == (2, T * tcfg.total_upsample)
    assert tuple(ts.shape) == js.shape
    assert np.abs(tw.numpy()).max() <= tcfg.audio_limit + 1e-6
    assert _rel(tw, jw) <= (WAVE_FIXED_TOL if fixed_source else WAVE_TOL)
    assert _rel(ts, js) <= (0.0 if fixed_source else SOURCE_TOL)


def test_hift_decode_chunk_three_chunks(pair):
    """Three chunks of 8 mel frames, each with the cache its predecessor
    left (the first with the zero cache, muted head)."""
    tcfg, jcfg, tp, jp = pair
    jc = jhift.init_hift_cache(jcfg, 2)
    tc = thift.init_hift_cache(tcfg, 2, "cpu")
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for i, T in enumerate((8, 8, 8)):
        mel = _mel(2, T, 10 + i)
        jw, jc = jhift.hift_decode_chunk(jp, jcfg, jnp.asarray(mel), jc)
        tw, tc = thift.hift_decode_chunk(tp, tcfg, torch.from_numpy(mel), tc)
        assert tuple(tw.shape) == jw.shape == (2, T * tcfg.total_upsample)
        assert _rel(tw, jw) <= WAVE_TOL, i
        if i == 0:  # the first chunk's head is muted
            n = thift.HIFT_CTX_FRAMES * tcfg.total_upsample
            assert not tw[:, :n].any()
        assert set(tc) == set(jc)
        for k in ("mel", "speech"):
            assert _rel(tc[k], jc[k]) <= WAVE_TOL, (i, k)
        assert _rel(tc["source"], jc["source"]) <= SOURCE_TOL, i
        np.testing.assert_array_equal(tc["primed"].numpy(),
                                      np.asarray(jc["primed"]))


def test_loader_matches_jax_on_synthetic_hift():
    tcfg, jcfg = thift.HiFTConfig(**SMALL), jhift.HiFTConfig(**SMALL)
    tp = thift.init_hift(tcfg, seeded_generator("cpu", 5), "cpu")
    sd = export_hift(tp)
    assert all(k.startswith("generator.") for k in sd)
    stripped = {k.replace("generator.", ""): v for k, v in sd.items()}
    got = thift.load_hift_params(stripped, tcfg)
    ref = jhift.load_hift_params({k: v.numpy() for k, v in stripped.items()},
                                 jcfg)
    flat = [jax.tree.leaves(t) for t in (got, ref, tp)]
    assert len({len(f) for f in flat}) == 1
    for g, r, s in zip(*flat):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), s.numpy())
