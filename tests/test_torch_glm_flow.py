"""Port parity, GLM-4-Voice's decoder: the GLM flow
(vox_serve_tpu_torch/codecs/glm_flow.py) and HiFT at GLM's configuration
(two upsample levels (8, 8), source resblock kernels (7, 11), 22,050 Hz:
256 samples per mel frame) against the JAX package's glm_flow.py and
hifigan.py, on the CPU in float32 at small widths (the JAX GLM test's
``SMALL_GLM_FLOW``: two U-Net levels, with two regulator layers), with
the same weights in both packages and inputs from numpy
seeds.

Tolerances, relative to max |ref| of each output:
* one estimator call (the U-Net with its stride-2 down, transposed-conv up
  and the skip crop) 1e-5: float32 layers summed in another order;
* ``glm_flow_forward`` (the encoder under the block mask, the regulator
  and two Euler steps on the doubled batch, from the same noise) 1e-4: the
  error carried from step to step;
* the block mask exact; the loader's tree equal leaf for leaf to JAX's on
  the exporter's ``flow.pt`` state dict;
* HiFT whole 1e-4 (the free sine source drifts in its float32 cumsum),
  with a fixed source 1e-5; three streamed 8-frame chunks with their
  caches: the waves and the caches' mel / speech tails 1e-4, the cached
  source 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_glm_flow, export_hift
from vox_serve_tpu.codecs import glm_flow as jflow
from vox_serve_tpu.codecs import hifigan as jhift
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import glm_flow as tflow
from vox_serve_tpu_torch.codecs import hifigan as thift
from vox_serve_tpu_torch.models.backbone import seeded_generator

torch.set_num_threads(1)

SMALL = dict(input_size=32, output_size=32, heads=4, linear_units=64,
             num_blocks=1, vocab_size=16384, spk_dim=8, mel_dim=16,
             est_channels=(16, 16), est_head_dim=8, est_heads=2,
             est_n_blocks=1, est_mid_blocks=1, n_timesteps=2,
             regulator_layers=2)
GLM_HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=4,
                sampling_rate=22050, upsample_rates=(8, 8),
                upsample_kernel_sizes=(16, 16),
                source_resblock_kernel_sizes=(7, 11), f0_cond_channels=16)
EST_TOL = 1e-5
FLOW_TOL = 1e-4
WAVE_FIXED_TOL = 1e-5
WAVE_TOL = 1e-4
SOURCE_TOL = 1e-3


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(),
                                                      tree))


@pytest.fixture(scope="module")
def flow():
    tcfg, jcfg = tflow.GLMFlowConfig(**SMALL), jflow.GLMFlowConfig(**SMALL)
    tp = tflow.init_glm_flow(tcfg, seeded_generator("cpu", 0), "cpu")
    # non-trivial norms and biases, so every leaf is exercised
    g = torch.Generator().manual_seed(1)
    tp = tparams.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=g), tp)
    return tcfg, jcfg, tp, _to_jax(tp)


def test_config_and_init_tree_match_jax(flow):
    tcfg, jcfg, tp, _ = flow
    full_t, full_j = tflow.GLMFlowConfig(), jflow.GLMFlowConfig()
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    for T in (1, 7, 25, 50, 100, 101):
        assert tcfg.feat_len(T) == jcfg.feat_len(T)
    assert full_t.feat_len(25) == 172 and full_t.feat_len(100) == 689
    ji = jflow.init_glm_flow(jcfg, jax.random.key(0))
    shapes = [tuple(a.shape) for a in jax.tree.leaves(ji)]
    assert shapes == [tuple(t.shape) for t in jax.tree.leaves(tp)]


@pytest.mark.parametrize("T,block", [(25, 10), (1, 10), (37, 4)])
def test_block_mask_exact(T, block):
    p = np.arange(T)
    ref = (p[None, :] <= p[:, None]) | (p[None, :] // block
                                        == p[:, None] // block)
    np.testing.assert_array_equal(tflow.block_mask(T, block, "cpu").numpy(),
                                  ref)


@pytest.mark.parametrize("T", [172, 173])
def test_estimator_matches_jax(flow, T):
    """One estimator call at an even and an odd frame count (the odd one
    crops the transposed conv's extra frame)."""
    tcfg, jcfg, tp, jp = flow
    rng = np.random.default_rng(2)
    B, M = 2, SMALL["mel_dim"]
    x, mu, cond = (rng.standard_normal((B, M, T)).astype(np.float32)
                   for _ in range(3))
    t = rng.random(B).astype(np.float32)
    spk = rng.standard_normal((B, M)).astype(np.float32)
    args = (x, mu, t, spk, cond)
    ref = jflow._estimator(jp["estimator"], jcfg, *map(jnp.asarray, args))
    got = tflow._estimator(tp["estimator"], tcfg,
                           *map(torch.from_numpy, args))
    assert tuple(got.shape) == ref.shape == (B, M, T)
    assert _rel(got, ref) <= EST_TOL


@pytest.mark.parametrize("T", [25, 50])
def test_flow_forward_matches_jax(flow, T):
    """The whole forward from the same per-row noise; the speaker row is
    zeros (GLM's detokenize), normalized by max(norm, 1e-12)."""
    tcfg, jcfg, tp, jp = flow
    rng = np.random.default_rng(3)
    B, F = 2, tcfg.feat_len(T)
    tokens = rng.integers(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    spk = np.zeros((B, SMALL["spk_dim"]), np.float32)
    noise = rng.standard_normal((B, SMALL["mel_dim"], F)).astype(np.float32)
    ref = jflow.glm_flow_forward(jp, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(spk), None,
                                 noise=jnp.asarray(noise))
    got = tflow.glm_flow_forward(tp, tcfg, torch.from_numpy(tokens),
                                 torch.from_numpy(spk),
                                 noise=torch.from_numpy(noise))
    assert tuple(got.shape) == ref.shape == (B, SMALL["mel_dim"], F)
    assert _rel(got, ref) <= FLOW_TOL
    # a nonzero speaker row takes the same normalization
    spk = rng.standard_normal((B, SMALL["spk_dim"])).astype(np.float32)
    ref = jflow.glm_flow_forward(jp, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(spk), None,
                                 noise=jnp.asarray(noise))
    got = tflow.glm_flow_forward(tp, tcfg, torch.from_numpy(tokens),
                                 torch.from_numpy(spk),
                                 noise=torch.from_numpy(noise))
    assert _rel(got, ref) <= FLOW_TOL


def test_shared_noise_row_broadcasts(flow):
    """A (1, mel, F) noise (the model's per-length buffer) starts every row
    from the same noise: equal to passing it tiled."""
    tcfg, _, tp, _ = flow
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, 100, (2, 25)))
    spk = torch.zeros((2, SMALL["spk_dim"]))
    noise = torch.from_numpy(rng.standard_normal(
        (1, SMALL["mel_dim"], tcfg.feat_len(25))).astype(np.float32))
    a = tflow.glm_flow_forward(tp, tcfg, tokens, spk, noise=noise)
    b = tflow.glm_flow_forward(tp, tcfg, tokens, spk,
                               noise=noise.expand(2, -1, -1).contiguous())
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_loader_matches_jax_on_synthetic_flow(flow):
    tcfg, jcfg, tp, _ = flow
    sd = export_glm_flow(tp)
    got = tflow.load_glm_flow_params(sd, tcfg)
    ref = jflow.load_glm_flow_params({k: v.numpy() for k, v in sd.items()},
                                     jcfg)
    flat = [jax.tree.leaves(t) for t in (got, ref, tp)]
    assert len({len(f) for f in flat}) == 1
    for g, r, s in zip(*flat):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), s.numpy())
    assert "decoder.estimator.down_blocks.0.2.conv.weight" in sd
    assert "decoder.estimator.down_blocks.1.2.weight" in sd
    assert "decoder.estimator.up_blocks.0.2.conv.weight" in sd
    assert "length_regulator.model.6.weight" in sd  # 2 layers x 3, then out


# ---------------------------------------------------------------------------
# HiFT at GLM's configuration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hift():
    tcfg, jcfg = thift.HiFTConfig(**GLM_HIFT), jhift.HiFTConfig(**GLM_HIFT)
    tp = thift.init_hift(tcfg, seeded_generator("cpu", 7), "cpu")
    g = torch.Generator().manual_seed(8)
    for r in tp["resblocks"] + tp["source_resblocks"]:
        for k in ("alpha1", "alpha2"):
            r[k] = [a + 0.3 * torch.rand(a.shape, generator=g) for a in r[k]]
    tp["f0_out_w"] = tp["f0_out_w"] * 50.0  # a voiced source around 120 Hz
    tp["f0_out_b"] = tp["f0_out_b"] + 120.0
    return tcfg, jcfg, tp, _to_jax(tp)


def _mel(B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, GLM_HIFT["in_channels"], T)).astype(np.float32)


def test_hift_config_is_two_levels(hift):
    tcfg, jcfg, tp, _ = hift
    assert tcfg.total_upsample == jcfg.total_upsample == 256
    assert tcfg.source_down == [8, 1]
    assert len(tp["ups"]) == len(tp["source_resblocks"]) == 2
    assert len(tp["resblocks"]) == 6


@pytest.mark.parametrize("fixed_source", [True, False])
def test_hift_decode_matches_jax(hift, fixed_source):
    tcfg, jcfg, tp, jp = hift
    T = 14
    mel = _mel(2, T, 2)
    src = None
    if fixed_source:
        src = np.random.default_rng(3).uniform(
            -0.1, 0.1, (2, 1, T * 256)).astype(np.float32)
    jw, js = jhift.hift_decode(jp, jcfg, jnp.asarray(mel),
                               None if src is None else jnp.asarray(src))
    tw, ts = thift.hift_decode(tp, tcfg, torch.from_numpy(mel),
                               None if src is None else torch.from_numpy(src))
    assert tuple(tw.shape) == jw.shape == (2, T * 256)
    assert _rel(tw, jw) <= (WAVE_FIXED_TOL if fixed_source else WAVE_TOL)
    assert _rel(ts, js) <= (0.0 if fixed_source else SOURCE_TOL)


def test_hift_chunks_match_jax(hift):
    """Three streamed chunks of 8 frames, each with the cache its
    predecessor left (test_torch_hift.py's chunk test, at GLM's levels).
    A whole 172-frame GLM window drifts further in the sine source's
    float32 cumsum (measured 1.03e-4 of the wave's peak over 45,568
    samples); the worker test holds such windows' PCM to 4 int16 steps."""
    tcfg, jcfg, tp, jp = hift
    jc = jhift.init_hift_cache(jcfg, 2)
    tc = thift.init_hift_cache(tcfg, 2, "cpu")
    for i, T in enumerate((8, 8, 8)):
        mel = _mel(2, T, 10 + i)
        jw, jc = jhift.hift_decode_chunk(jp, jcfg, jnp.asarray(mel), jc)
        tw, tc = thift.hift_decode_chunk(tp, tcfg, torch.from_numpy(mel), tc)
        assert tuple(tw.shape) == jw.shape == (2, T * 256)
        assert _rel(tw, jw) <= WAVE_TOL, i
        for k in ("mel", "speech"):
            assert _rel(tc[k], jc[k]) <= WAVE_TOL, (i, k)
        assert _rel(tc["source"], jc["source"]) <= SOURCE_TOL, i
        np.testing.assert_array_equal(tc["primed"].numpy(),
                                      np.asarray(jc["primed"]))


def test_hift_loader_at_glm_config(hift):
    """``hift.pt``'s ``generator.`` names, stripped as the model strips
    them: the port's tree equals JAX's and the weights written."""
    tcfg, jcfg, tp, _ = hift
    sd = {k.replace("generator.", ""): v for k, v in export_hift(tp).items()}
    got = thift.load_hift_params(sd, tcfg)
    ref = jhift.load_hift_params({k: v.numpy() for k, v in sd.items()},
                                 jcfg)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, s in zip(jax.tree.leaves(got), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(g.numpy(), s.numpy())
