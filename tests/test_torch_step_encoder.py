"""Port parity, Step-Audio 2's audio encoder and adaptor
(vox_serve_tpu_torch/encoders/whisper_exact.py) against the JAX package's
vox_serve_tpu/encoders/whisper_exact.py, on the CPU in float32 at the
debug config StepAudio2LM serves with a debug backbone (16 mels, width 64,
4 heads, 2 layers, adaptor hidden 32, LLM width 64), the JAX init's
weights carried into the port through ``params.tree_to_torch`` (norms and
biases perturbed), mel inputs from numpy seeds.

* ``step_encode`` + ``step_adaptor``: 1e-4 relative to the output's peak,
  without ``valid_frames`` and with it, at odd and even mel lengths (the
  key mask subsamples ``keep[(T_in + 1) % 2::2]``, checked exactly);
* ``load_step_encoder_params`` on the exporter's state dict
  (``synthetic_checkpoints.export_step_encoder``): the tree equal leaf
  for leaf to JAX's loader's and to the weights written;
* the adaptor row count of a clip (``step_audio_rows``) against the
  encoder's output length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_checkpoints import export_step_encoder
from vox_serve_tpu.encoders import whisper_exact as jw
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import whisper_exact as tw
from vox_serve_tpu_torch.models.step_audio_2 import step_audio_rows

torch.set_num_threads(1)

KW = dict(n_mels=16, d_model=64, heads=4, layers=2, llm_dim=64,
          adapter_hidden=32)
TOL = 1e-4  # relative to the output's peak


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jw.StepEncConfig(**KW), tw.StepEncConfig(**KW)
    jp = jw.init_step_encoder_params(jax.random.key(41), jcfg)
    rng = np.random.default_rng(1)
    # non-trivial norms and biases (the JAX init's are ones and zeros)
    jp = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jp)
    tp = tparams.tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _mel(T, seed, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, KW["n_mels"], T)).astype(np.float32)


@pytest.mark.parametrize("T_in,valid", [(302, None), (302, 302), (301, 240),
                                        (300, 171), (97, 60)])
def test_encode_and_adaptor_match_jax(pair, T_in, valid):
    """Mels of odd and even length, unpadded and with the tail beyond
    ``valid`` mel frames masked as keys."""
    jcfg, tcfg, jp, tp = pair
    mel = _mel(T_in, T_in)
    ref = jw.step_encode(jp, jcfg, jnp.asarray(mel), valid_frames=valid)
    got = tw.step_encode(tp, tcfg, torch.from_numpy(mel), valid_frames=valid)
    assert tuple(got.shape) == ref.shape == (2, ((T_in - 1) // 2 + 1) // 2,
                                             64)
    assert _rel(got, ref) <= TOL
    ref_a = jw.step_adaptor(jp, jcfg, ref)
    got_a = tw.step_adaptor(tp, tcfg, got)
    assert tuple(got_a.shape) == ref_a.shape
    assert _rel(got_a, ref_a) <= TOL
    if valid is not None and valid < T_in:
        # the mask changes the output (the masked keys are real)
        free = tw.step_encode(tp, tcfg, torch.from_numpy(mel))
        assert _rel(free, got.numpy()) > 1e-3


@pytest.mark.parametrize("T_in", [300, 301, 302, 303])
def test_key_mask_subsamples_like_jax(T_in):
    """``keep[(T_in + 1) % 2::2][:T]``, element for element: an odd T_in
    keeps even mel frames, an even one odd frames."""
    T = (T_in - 1) // 2 + 1
    for valid in (T_in, T_in - 1, T_in - 2, 101):
        keep = np.arange(T_in) < valid
        keep = keep[(T_in + 1) % 2::2][:T]
        want = np.broadcast_to(np.where(keep, 0.0, jw.NEG)[None], (T, T))
        got = tw.step_key_mask(T_in, T, valid, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_loader_matches_jax_on_synthetic_state(pair):
    jcfg, tcfg, jp, tp = pair
    sd = export_step_encoder(tp)
    assert "encoder.blocks.0.attn.key.bias" not in sd  # k: no bias
    assert "encoder.blocks.1.mlp_ln.bias" in sd
    assert "adapter.linear2.weight" in sd
    got = tw.load_step_encoder_params(sd, tcfg)
    ref = jw.load_step_encoder_params({k: v.numpy() for k, v in sd.items()},
                                      jcfg)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, ref))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, got)))
    n = []

    def same(a, b, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), w.numpy())
        n.append(1)

    tparams.tree_map(same, got, ref, tp)
    # stems 4, positions, 2 layers of 15, final norm 2, adaptor 6
    assert len(n) == len(jax.tree.leaves(ref)) == 4 + 1 + 2 * 15 + 2 + 6


@pytest.mark.parametrize("seconds", [1.0, 1.5, 3.0, 4.2])
def test_audio_rows_follow_the_encoder(pair, seconds):
    """``step_audio_rows`` (the smoke's host-side count) against the rows
    the log-mel, encoder and adaptor make of a clip (3 s: 18 rows)."""
    jcfg, tcfg, jp, tp = pair
    n = int(seconds * 16000)
    wav = np.sin(np.arange(n) * 0.05).astype(np.float32) * 0.3
    mel = tw.whisper_log_mel(wav, n_mels=16, padding=479)
    out = tw.step_adaptor(tp, tcfg, tw.step_encode(
        tp, tcfg, torch.from_numpy(mel)[None], valid_frames=mel.shape[1]))
    assert out.shape[1] == step_audio_rows(n)
    if seconds == 3.0:
        assert mel.shape[1] == 302 and step_audio_rows(n) == 18
