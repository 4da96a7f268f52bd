"""Port parity, Step-Audio 2's DiT flow (vox_serve_tpu_torch/codecs/
step_dit.py) against the JAX package's vox_serve_tpu/codecs/step_dit.py,
on the CPU in float32 at the reduced config of the JAX golden test
(``tests/test_step_dit_parity.py``: 2 + 1 conformer blocks, 2 DiT blocks
of width 64 with 4 heads of 16, 10 solver steps), the JAX init's weights
carried into the port through ``params.tree_to_torch`` (norms, biases and
the adaLN projections perturbed, so every modulation is live), inputs
from numpy seeds.

* the timestep embedding ([cos, sin], 128 frequencies, scale 1000), the
  affine-free LayerNorm, the causal conv block and one DiT attention:
  1e-5 relative;
* ``_dit_forward`` (the estimator alone) at 40 and 47 frames: 1e-4
  relative to the output's peak;
* ``step_flow_forward`` with ``context=3`` (the window's last 3 tokens
  lookahead) and the same start ``noise`` in both packages: the mel
  within 1e-4 of the peak, 2 (T - 3) frames, with and without a speaker
  row and cond rows;
* ``load_step_flow_params`` on the exporter's ``flow.pt`` state dict
  (``synthetic_checkpoints.export_step_flow``): the tree equal leaf for
  leaf to JAX's loader's and to the weights written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_step_flow
from vox_serve_tpu.codecs import step_dit as jsd
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import step_dit as tsd

torch.set_num_threads(1)

CFG = dict(num_blocks=2, up_blocks=1, linear_units=128, vocab_size=100,
           dit_depth=2, dit_hidden=64, dit_heads=4, dit_head_dim=16,
           n_timesteps=10)
PART_TOL = 1e-5
TOL = 1e-4  # relative to the output's peak


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jsd.StepFlowConfig(**CFG), tsd.StepFlowConfig(**CFG)
    jp = jsd.init_step_flow(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    jp = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jp)
    tp = tparams.tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_parts_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    t = np.array([0.0, 0.03, 0.5, 0.97], np.float32)
    half = 128
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    args = 1000.0 * t[:, None] * freqs[None]
    want = np.concatenate([np.cos(args), np.sin(args)], -1)
    got = tsd._timestep_embedding(torch.from_numpy(t))
    assert got.shape == (4, 256)
    assert np.abs(got.numpy() - want).max() <= 1e-3  # f32 args up to 1000
    x = _np(0, 2, 19, 64)
    ref = jsd._plain_ln(jnp.asarray(x))
    assert _rel(tsd._plain_ln(torch.from_numpy(x)), ref) <= PART_TOL
    bj, bt = jp["estimator"]["blocks"][0], tp["estimator"]["blocks"][0]
    ref = jsd._dit_conv_block(bj["conv"], jnp.asarray(x))
    got = tsd._dit_conv_block(bt["conv"], torch.from_numpy(x))
    assert _rel(got, ref) <= PART_TOL
    # causal: frame 0 depends on no later frame
    x2 = x.copy()
    x2[:, 1:] += 1.0
    got2 = tsd._dit_conv_block(bt["conv"], torch.from_numpy(x2))
    np.testing.assert_allclose(got2[:, 0].numpy(), got[:, 0].numpy(),
                               rtol=0, atol=1e-6)
    ref = jsd._dit_attention(bj["attn"], jcfg, jnp.asarray(x))
    got = tsd._dit_attention(bt["attn"], tcfg, torch.from_numpy(x))
    assert _rel(got, ref) <= PART_TOL


@pytest.mark.parametrize("T", [40, 47])
def test_dit_forward_matches_jax(pair, T):
    jcfg, tcfg, jp, tp = pair
    B, mel = 2, jcfg.mel_dim
    x, mu, cond = (_np(s, B, mel, T) for s in (1, 2, 3))
    spks = _np(4, B, mel)
    t = np.array([0.1, 0.7], np.float32)
    ref = jsd._dit_forward(jp["estimator"], jcfg, *(jnp.asarray(a) for a in
                                                    (x, mu, t, spks, cond)))
    got = tsd._dit_forward(tp["estimator"], tcfg,
                           *(torch.from_numpy(a) for a in
                             (x, mu, t, spks, cond)))
    assert tuple(got.shape) == ref.shape == (B, mel, T)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("W,spk", [(28, False), (28, True), (20, True)])
def test_flow_forward_with_context_matches_jax(pair, W, spk):
    """A window of W tokens whose last 3 are lookahead: 2 (W - 3) mel
    frames from the same start noise in both packages; a zero speaker row
    and zero conds (as the model serves), or random ones."""
    jcfg, tcfg, jp, tp = pair
    B, mel, T2 = 2, jcfg.mel_dim, 2 * (W - 3)
    tokens = np.random.default_rng(W).integers(0, CFG["vocab_size"],
                                               (B, W)).astype(np.int32)
    spk_v = _np(5, B, jcfg.spk_dim) if spk else np.zeros(
        (B, jcfg.spk_dim), np.float32)
    conds = _np(6, B, T2, mel) if spk else np.zeros((B, T2, mel), np.float32)
    noise = _np(7, 1, mel, T2)
    ref = jsd.step_flow_forward(
        jp, jcfg, jnp.asarray(tokens), jnp.ones((B, W), bool),
        jnp.asarray(spk_v), jnp.asarray(conds), jax.random.key(0),
        context=3, noise=jnp.asarray(noise))
    got = tsd.step_flow_forward(
        tp, tcfg, torch.from_numpy(tokens), torch.ones((B, W), dtype=bool),
        torch.from_numpy(spk_v), torch.from_numpy(conds),
        noise=torch.from_numpy(noise), context=3)
    assert tuple(got.shape) == ref.shape == (B, mel, T2)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, ref) <= TOL


def test_loader_matches_jax_on_synthetic_state(pair):
    jcfg, tcfg, jp, tp = pair
    sd = export_step_flow(tp)
    for k in ("decoder.estimator.blocks.1.conv.block.6.weight",
              "decoder.estimator.blocks.0.attn.q_norm.bias",
              "decoder.estimator.final_layer.adaLN_modulation.1.weight",
              "encoder.up_encoders.0.self_attn.pos_bias_u",
              "encoder.pre_lookahead_layer.conv1.weight"):
        assert k in sd, k
    got = tsd.load_step_flow_params(sd, tcfg)
    ref = jsd.load_step_flow_params({k: v.numpy() for k, v in sd.items()},
                                    jcfg)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, ref))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, got)))
    n = []

    def same(a, b, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), w.numpy())
        n.append(1)

    tparams.tree_map(same, got, ref, tp)
    assert len(n) == len(jax.tree.leaves(ref)) == len(sd)
