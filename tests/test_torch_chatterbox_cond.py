"""Port parity, Chatterbox's conditioning (vox_serve_tpu_torch/encoders/
chatterbox_cond.py, encoders/perceiver.py and ``ChatterboxLM._cond_fn``)
against the JAX package, on the CPU in float32:

* the weight-exact conditioning encoder at the published C = 1024 with 4
  heads: one AttentionBlock2, the perceiver (cross, then self), and the 34
  rows [speaker, 32 prompt rows, emotion] (and the 2 rows without a
  prompt), within 1e-4;
* the perceiver resampler at C = 1024 with 16 heads (the dev path's
  config) and with 4, a padded prompt masked, within 1e-4;
* ``load_chatterbox_cond_params`` of both packages on the exporter's
  ``cond_enc.*`` state, leaf for leaf, and the init trees' structure;
* the dev ``_cond_fn`` path (the dev speaker encoder over a log-mel, the
  perceiver and the emotion row) with the same parameters, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from vox_serve_tpu.encoders import chatterbox_cond as jcond
from vox_serve_tpu.encoders import perceiver as jperc
from vox_serve_tpu.models import chatterbox as jchat
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import chatterbox_cond as tcond
from vox_serve_tpu_torch.encoders import perceiver as tperc
from vox_serve_tpu_torch.encoders.speaker import (SpeakerEncoderConfig,
                                                  init_speaker_encoder)
from vox_serve_tpu_torch.models import chatterbox as tchat

torch.set_num_threads(1)

TOL = 1e-4  # float32, absolute, on O(1) rows


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(
        lambda t: t.numpy(), tree))


@pytest.fixture(scope="module")
def cond():
    tp = tcond.init_chatterbox_cond_params(torch.Generator().manual_seed(1),
                                           "cpu")
    # non-trivial norms and biases, so the loader's names all matter
    g = torch.Generator().manual_seed(2)
    for k in ("norm_w", "norm_b", "spkr_b"):
        tp[k] = tp[k] + 0.1 * torch.randn(tp[k].shape, generator=g)
    for n in ("to_q", "to_k", "to_v", "proj_out"):
        tp[n]["b"] = 0.1 * torch.randn(tp[n]["b"].shape, generator=g)
    return tp, _to_jax(tp)


def flat(tree, prefix="") -> dict:
    """{path: numpy array} of a nested dict/list tree of tensors or
    arrays (the same paths for a port tree and a JAX tree)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: (tree.numpy() if torch.is_tensor(tree)
                         else np.asarray(tree))}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def _rows(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_attention_block_and_perceiver_match_jax(cond):
    tp, jp = cond
    x1, x2 = _rows(0, 2, 32, 1024), _rows(1, 2, 57, 1024)
    got = tcond._attn_block(tp, torch.from_numpy(x1), torch.from_numpy(x2))
    ref = jcond._attn_block(jp, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    got = tcond.chatterbox_perceiver(tp, torch.from_numpy(x2))
    ref = jcond.chatterbox_perceiver(jp, jnp.asarray(x2))
    assert got.shape == (2, tcond.N_QUERY, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("n_prompt", [150, 7, None])
def test_cond_encode_matches_jax(cond, n_prompt):
    tp, jp = cond
    spk = _rows(3, 256)
    emb = None if n_prompt is None else _rows(4, n_prompt, 1024)
    for emo in (0.5, 1.3):
        got = tcond.chatterbox_cond_encode(
            tp, torch.from_numpy(spk),
            None if emb is None else torch.from_numpy(emb), emo)
        ref = jcond.chatterbox_cond_encode(
            jp, jnp.asarray(spk), None if emb is None else jnp.asarray(emb),
            emo)
        assert got.shape == ((tchat.COND_LEN if emb is not None else 2),
                             1024)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("heads", [16, 4])
def test_perceiver_resample_matches_jax(heads):
    tcfg = tperc.PerceiverConfig(in_dim=1024, hidden=1024, heads=heads)
    jcfg = jperc.PerceiverConfig(in_dim=1024, hidden=1024, heads=heads)
    tp = tperc.init_perceiver(tcfg, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(6)
    for lp in tp["layers"]:  # LayerNorm affines away from (1, 0)
        for k in ("nq_w", "nk_w", "nf_w"):
            lp[k] = lp[k] + 0.1 * torch.randn(lp[k].shape, generator=g)
        for k in ("nq_b", "nk_b", "nf_b"):
            lp[k] = 0.1 * torch.randn(lp[k].shape, generator=g)
    jp = _to_jax(tp)
    assert (jax.tree.structure(jax.tree.map(
        lambda a: 0, jperc.init_perceiver(jcfg, jax.random.key(0))))
        == jax.tree.structure(tparams.tree_map(lambda t: 0, tp)))
    feats = _rows(7, 2, 40, 1024)
    mask = np.ones((2, 40), bool)
    mask[1, 29:] = False  # a padded second prompt
    for m in (None, mask):
        got = tperc.perceiver_resample(
            tp, tcfg, torch.from_numpy(feats),
            None if m is None else torch.from_numpy(m))
        ref = jperc.perceiver_resample(
            jp, jcfg, jnp.asarray(feats), None if m is None else
            jnp.asarray(m))
        assert got.shape == (2, 32, 1024)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    # padding is ignored: the padded row equals its unpadded prompt
    short = tperc.perceiver_resample(tp, tcfg,
                                     torch.from_numpy(feats[1:, :29]))
    np.testing.assert_allclose(got[1:].numpy(), short.numpy(), atol=TOL)


def test_loaders_read_the_exporters_state_leaf_for_leaf(cond):
    tp, _ = cond
    sd = synth.export_chatterbox_cond(tp)
    assert all(k.startswith("cond_enc.") for k in sd) and len(sd) == 14
    got = tcond.load_chatterbox_cond_params(sd)
    assert all(t.dtype == torch.float32
               for t in tparams.tree_leaves(got))
    flat_g = flat(got)
    flat_r = flat(jcond.load_chatterbox_cond_params(
        {k: v.numpy() for k, v in sd.items()}))
    flat_t = flat(tp)
    assert set(flat_g) == set(flat_r) == set(flat_t) and len(flat_g) == 14
    for k, v in flat_g.items():
        np.testing.assert_array_equal(v, flat_r[k])
        np.testing.assert_array_equal(v, flat_t[k])
    jinit = flat(jcond.init_chatterbox_cond_params(jax.random.key(0)))
    assert {k: v.shape for k, v in jinit.items()} == {
        k: v.shape for k, v in flat_t.items()}


def test_dev_cond_fn_matches_jax():
    """The dev path with the same weights: the dev speaker encoder over a
    (1, 80, T) log-mel, the 16-head perceiver over (1, T', 1024) speech
    rows and the emotion row, in [speaker, latents, emotion] order."""
    H = 1024
    pcfg = tperc.PerceiverConfig(in_dim=H, hidden=H, heads=16, n_latents=32)
    g = torch.Generator().manual_seed(8)
    spk_cfg = SpeakerEncoderConfig(out_dim=256)
    cp = {"perceiver": tperc.init_perceiver(pcfg, g, "cpu"),
          "spk": init_speaker_encoder(spk_cfg, g, "cpu"),
          "spk_proj": torch.randn((256, H), generator=g) * 0.02,
          "emotion": torch.randn((1, H), generator=g) * 0.02}
    tm = tchat.ChatterboxLM.__new__(tchat.ChatterboxLM)
    tm._perc_cfg, tm.spk_cfg = pcfg, spk_cfg
    jm = jchat.ChatterboxLM.__new__(jchat.ChatterboxLM)
    jm._perc_cfg = jperc.PerceiverConfig(in_dim=H, hidden=H, heads=16,
                                         n_latents=32)
    mel = _rows(9, 1, 80, 120)
    feats = _rows(10, 1, 75, H)
    mask = np.ones((1, 75), bool)
    got = tm._cond_fn(cp, torch.from_numpy(mel), torch.from_numpy(feats),
                      torch.from_numpy(mask), 0.7)
    ref = jm._cond_fn(_to_jax(cp), jnp.asarray(mel), jnp.asarray(feats),
                      jnp.asarray(mask), jnp.float32(0.7))
    assert got.shape == (tchat.COND_LEN, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
