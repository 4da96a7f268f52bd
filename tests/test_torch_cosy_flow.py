"""Port parity, the CosyVoice2 flow decoder
(vox_serve_tpu_torch/codecs/cosyvoice_flow.py) against the JAX package's
vox_serve_tpu/codecs/cosyvoice_flow.py, on the CPU in float32 at the JAX
CosyVoice2 test's small widths (``SMALL_COSY_FLOW``), with the same
weights in both packages and inputs from numpy seeds.

Tolerances, relative to max |ref| of each output: 1e-5 for the conformer
encoder and one estimator call (a few float32 layers of matmuls summed in
another order); 1e-4 for the whole solver (two Euler steps, each an
estimator call on the doubled batch, the error carried from step to step).
The relative-position table and the rel-shift are exact; the loaders'
trees are equal leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_cosy_flow
from vox_serve_tpu.codecs import cosyvoice_flow as jflow
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import cosyvoice_flow as tflow
from vox_serve_tpu_torch.models.backbone import seeded_generator

torch.set_num_threads(1)

SMALL = dict(input_size=32, output_size=32, heads=4, linear_units=64,
             num_blocks=1, up_blocks=1, vocab_size=6561, spk_dim=8,
             mel_dim=16, est_channels=16, est_head_dim=8, est_heads=2,
             est_n_blocks=1, est_mid_blocks=1, n_timesteps=2)
#: two mid blocks and two transformer blocks per level, so the lists of
#: the tree have more than one entry
WIDER = dict(SMALL, num_blocks=2, up_blocks=2, est_n_blocks=2,
             est_mid_blocks=2)
ENC_TOL = 1e-5
EST_TOL = 1e-5
FLOW_TOL = 1e-4


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _pair(cfg_kw, seed=0):
    """Both configs and the port's random weights, converted for JAX."""
    tcfg = tflow.CosyFlowConfig(**cfg_kw)
    jcfg = jflow.CosyFlowConfig(**cfg_kw)
    tp = tflow.init_cosy_flow(tcfg, seeded_generator("cpu", seed), "cpu")
    # non-trivial norms and biases, so every leaf is exercised
    g = torch.Generator().manual_seed(seed + 1)
    tp = tparams.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=g), tp)
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), tp))
    return tcfg, jcfg, tp, jp


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


def _inputs(B, T, cfg_kw, seed, pad=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg_kw["vocab_size"], (B, T)).astype(np.int32)
    valid = np.ones((B, T), bool)
    if pad:
        valid[0, :3] = False          # left context not yet streamed
        valid[-1, T - 2:] = False     # a padded tail
    spk = rng.standard_normal((B, cfg_kw["spk_dim"])).astype(np.float32)
    conds = np.zeros((B, 2 * T, cfg_kw["mel_dim"]), np.float32)
    conds[:, :7] = rng.standard_normal((B, 7, cfg_kw["mel_dim"]))
    return tokens, valid, spk, conds


def test_rel_pos_table_and_shift_exact():
    for d, T in ((32, 1), (32, 7), (512, 53)):
        np.testing.assert_array_equal(
            tflow._rel_pos_emb(d, T, "cpu").numpy(), jflow._rel_pos_emb(d, T))
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 9)).astype(
        np.float32)
    np.testing.assert_array_equal(tflow._rel_shift(torch.from_numpy(x)),
                                  np.asarray(jflow._rel_shift(jnp.asarray(x))))
    np.testing.assert_array_equal(tflow._chunk_mask(60, 25, "cpu").numpy(),
                                  jflow._chunk_mask(60, 25))


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("context", [0, 3])
def test_encoder_matches_jax(small, streaming, context):
    tcfg, jcfg, tp, jp = small
    rng = np.random.default_rng(1)
    B, T = 2, 53
    emb = rng.standard_normal((B, T, SMALL["input_size"])).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, :4] = False
    ref = jflow._encoder_forward(jp, jcfg, jnp.asarray(emb),
                                 jnp.asarray(valid), streaming, context)
    got = tflow._encoder_forward(tp, tcfg, torch.from_numpy(emb),
                                 torch.from_numpy(valid), streaming, context)
    assert tuple(got.shape) == ref.shape == (B, 2 * (T - context),
                                             SMALL["output_size"])
    assert _rel_err(got, ref) <= ENC_TOL


@pytest.mark.parametrize("streaming", [True, False])
def test_estimator_matches_jax(small, streaming):
    tcfg, jcfg, tp, jp = small
    rng = np.random.default_rng(2)
    B, T, M = 4, 106, SMALL["mel_dim"]  # the solver's doubled batch
    x, mu, cond = (rng.standard_normal((B, M, T)).astype(np.float32)
                   for _ in range(3))
    mask = np.ones((B, 1, T), np.float32)
    mask[0, :, :10] = 0.0
    t = rng.random(B).astype(np.float32)
    spk = rng.standard_normal((B, M)).astype(np.float32)
    args = (x, mask, mu, t, spk, cond)
    ref = jflow._estimator_forward(jp["estimator"], jcfg,
                                   *map(jnp.asarray, args), streaming)
    got = tflow._estimator_forward(tp["estimator"], tcfg,
                                   *map(torch.from_numpy, args), streaming)
    assert _rel_err(got, ref) <= EST_TOL


@pytest.mark.parametrize("streaming", [True, False])
def test_flow_forward_with_jax_noise(small, streaming):
    """The whole solver, both packages starting from the noise JAX draws
    (``jax.random.key(0)``, as its detokenize does)."""
    tcfg, jcfg, tp, jp = small
    B, T = 2, 53
    tokens, valid, spk, conds = _inputs(B, T, SMALL, 3)
    noise = jax.random.normal(jax.random.key(0), (1, SMALL["mel_dim"], 2 * T))
    ref = jflow.cosy_flow_forward(jp, jcfg, *map(jnp.asarray,
                                                 (tokens, valid, spk, conds)),
                                  None, streaming=streaming, noise=noise)
    got = tflow.cosy_flow_forward(tp, tcfg, *map(torch.from_numpy,
                                                 (tokens, valid, spk, conds)),
                                  noise=torch.from_numpy(np.array(noise)),
                                  streaming=streaming)
    assert tuple(got.shape) == (B, SMALL["mel_dim"], 2 * T)
    assert np.isfinite(got.numpy()).all()
    assert _rel_err(got, ref) <= FLOW_TOL


def test_wider_tree_flow_matches_jax():
    """More than one block at every level (the lists of the tree)."""
    tcfg, jcfg, tp, jp = _pair(WIDER, seed=4)
    tokens, valid, spk, conds = _inputs(2, 53, WIDER, 5, pad=False)
    noise = np.random.default_rng(6).standard_normal(
        (1, WIDER["mel_dim"], 106)).astype(np.float32)
    ref = jflow.cosy_flow_forward(jp, jcfg, *map(jnp.asarray,
                                                 (tokens, valid, spk, conds)),
                                  None, noise=jnp.asarray(noise))
    got = tflow.cosy_flow_forward(tp, tcfg, *map(torch.from_numpy,
                                                 (tokens, valid, spk, conds)),
                                  noise=torch.from_numpy(noise))
    assert _rel_err(got, ref) <= FLOW_TOL


def test_timesteps_match_jax():
    """Within one float32 step at 1.0 (numpy's cos against XLA's)."""
    ts = jnp.linspace(0.0, 1.0, 11)
    ref = np.asarray(1.0 - jnp.cos(ts * 0.5 * jnp.pi))
    np.testing.assert_allclose(tflow.cfm_timesteps(10), ref, rtol=0,
                               atol=2.0 ** -23)


@pytest.mark.parametrize("prefix", ["", "flow."])
def test_loader_matches_jax_on_synthetic_state(prefix):
    """``load_cosy_flow_params`` on the exporter's state dict (torch
    tensors, as ``torch.load`` gives them) and JAX's loader on the same
    arrays: the same tree, leaf for leaf, equal to the exported params."""
    tcfg, jcfg, tp, _ = _pair(WIDER, seed=7)
    sd = {prefix + k: v for k, v in export_cosy_flow(tp).items()}
    got = tflow.load_cosy_flow_params(sd, tcfg, prefix)
    ref = jflow.load_cosy_flow_params({k: v.numpy() for k, v in sd.items()},
                                      jcfg, prefix)
    # jax.tree orders dict keys; torch tensors are leaves to it
    flat_got, flat_ref, flat_src = (jax.tree.leaves(t) for t in (got, ref,
                                                                  tp))
    assert len(flat_got) == len(flat_ref) == len(flat_src)
    assert (jax.tree.structure(tparams.tree_map(lambda t: 0, got))
            == jax.tree.structure(jax.tree.map(lambda a: 0, ref)))
    for g, r, s in zip(flat_got, flat_ref, flat_src):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), s.numpy())
