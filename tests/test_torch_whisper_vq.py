"""Port parity, GLM-4-Voice's Whisper-VQ speech tokenizer
(vox_serve_tpu_torch/encoders/whisper_exact.py) against the JAX package's
vox_serve_tpu/encoders/whisper_exact.py, on the CPU in float32 at the
debug config GLMVoiceLM serves with a debug backbone (``VQ_DEBUG``: 16
mels, width 64, 4 heads, 2 layers, 8-frame blocks, the full 16,384-row
codebook), with the same weights in both packages and mel inputs from
numpy seeds.

* the causal and plain conv stems, one Whisper layer and the block-causal
  mask: 1e-5 relative (the mask exact);
* ``glm_vq_encode``: the tokens exactly equal to JAX's, with and without
  key padding (``valid_frames``); each case prints the smallest gap
  between a frame's nearest and second-nearest codebook distance, which
  says how far the argmin is from a tie;
* ``load_glm_vq_params`` on the exporter's state dict
  (``synthetic_checkpoints.export_glm_vq``): the tree equal leaf for leaf
  to JAX's loader's and to the weights written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_glm_vq
from vox_serve_tpu.encoders import whisper_exact as jw
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import whisper_exact as tw
from vox_serve_tpu_torch.models.backbone import seeded_generator
from vox_serve_tpu_torch.models.glm_voice import VQ_DEBUG

torch.set_num_threads(1)

KW = dict(n_mels=16, d_model=64, heads=4, ffn=128, layers=2, block=8,
          vocab=16384, max_positions=256)
TOL = 1e-5


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    tcfg, jcfg = tw.GLMVQConfig(**KW), jw.GLMVQConfig(**KW)
    assert tcfg == VQ_DEBUG
    tp = tw.init_glm_vq_params(seeded_generator("cpu", 0), tcfg, "cpu")
    g = torch.Generator().manual_seed(1)
    # non-trivial norms and biases
    tp = tparams.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=g), tp)
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), tp))
    return tcfg, jcfg, tp, jp


def _mel(B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, KW["n_mels"], T)).astype(np.float32)


def test_stems_layer_and_mask_match_jax(pair):
    tcfg, jcfg, tp, jp = pair
    mel = _mel(2, 40, 0)
    for stride in (1, 2):
        w, b = tp["conv1_w"], tp["conv1_b"]
        ref = jw._causal_conv1d(jnp.asarray(w.numpy()),
                                jnp.asarray(b.numpy()), jnp.asarray(mel),
                                stride)
        got = tw._causal_conv1d(w, b, torch.from_numpy(mel), stride)
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= TOL
        ref = jw._conv1d(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                         jnp.asarray(mel), stride, 1)
        got = tw._conv1d(w, b, torch.from_numpy(mel), stride, 1)
        assert _rel(got, ref) <= TOL
    x = np.random.default_rng(1).standard_normal((2, 20, 64)).astype(
        np.float32)
    mask = tw.glm_vq_block_mask(20, 8, 13, "cpu")
    idx = np.arange(20)
    allowed = ((idx[:, None] >= idx[None, :])
               | (idx[:, None] // 8 == idx[None, :] // 8)) & (idx[None] < 13)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.where(allowed, 0.0, jw.NEG))
    ref = jw._layer(jp["layers"][0], jnp.asarray(x), jnp.asarray(
        mask.numpy()), 4)
    got = tw._layer(tp["layers"][0], torch.from_numpy(x), mask, 4)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("valid_mel", [None, 83, 41])
def test_tokens_exact(pair, valid_mel):
    """Tokens of two 96-frame mels (48 encoder frames, 12 tokens, six
    8-frame blocks), unpadded or with the tail beyond ``valid_mel`` mel
    frames masked as keys (the model's ``(valid + 1) // 2``)."""
    tcfg, jcfg, tp, jp = pair
    mel = _mel(2, 96, 2)
    vf = None if valid_mel is None else (valid_mel + 1) // 2
    if valid_mel is not None:
        mel[:, :, valid_mel:] = 0.0
    ref = np.asarray(jw.glm_vq_encode(jp, jcfg, jnp.asarray(mel),
                                      valid_frames=vf))
    got = tw.glm_vq_encode(tp, tcfg, torch.from_numpy(mel), valid_frames=vf)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape == (2,
                                                                         12)
    d = tw.glm_vq_distances(tp, tcfg, torch.from_numpy(mel), vf)
    top2 = torch.topk(d, 2, dim=-1, largest=False).values
    gap = float((top2[..., 1] - top2[..., 0]).min())
    print(f"valid_mel={valid_mel}: smallest nearest/second distance gap "
          f"{gap:.4f} (distances ~{float(top2[..., 0].mean()):.1f})")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1


def test_loader_matches_jax_on_synthetic_state(pair):
    tcfg, jcfg, tp, _ = pair
    sd = export_glm_vq(tp)
    assert "layers.0.self_attn.k_proj.bias" not in sd  # k: no bias
    assert "layers.1.final_layer_norm.bias" in sd
    got = tw.load_glm_vq_params(sd, tcfg)
    ref = jw.load_glm_vq_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat = [jax.tree.leaves(t) for t in (got, ref, tp)]
    assert len({len(f) for f in flat}) == 1
    for g, r, s in zip(*flat):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), s.numpy())
    # the JAX init makes the same tree
    ji = jw.init_glm_vq_params(jax.random.key(0), jcfg)
    assert ([a.shape for a in jax.tree.leaves(ji)]
            == [tuple(t.shape) for t in jax.tree.leaves(tp)])
