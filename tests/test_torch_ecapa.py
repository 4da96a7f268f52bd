"""Port parity, the ECAPA-TDNN speaker encoder of the Qwen3-TTS Base variant
(vox_serve_tpu_torch/encoders/ecapa.py) against vox_serve_tpu/encoders/
ecapa.py, on the CPU in float32.

* ``qwen3_speaker_mel`` and ``slaney_mel_filterbank`` equal (numpy copies);
* ``ecapa_embed`` at the published widths (mel 128, channels 4 x 512 +
  1536, embedding 2048) on the port's random params copied into the JAX
  tree: within 1e-5 of max |ref|, over clips of 3 mel frames (shorter than
  the largest reflect pad, 4: kernel 3 at dilation 4), 9 and 60 frames,
  and a batch of two;
* the reflect padding of a (B, C, T) signal by more than T equals
  ``jnp.pad(mode="reflect")``;
* ``load_ecapa_params`` on the exported ``speaker_encoder.*`` tensors
  equals the JAX mapper's tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from test_torch_weights import assert_trees_equal
from vox_serve_tpu.encoders import ecapa as jecapa
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import ecapa
from vox_serve_tpu_torch.watermark.spectral import reflect_pad

torch.set_num_threads(1)

REL_TOL = 1e-5


def _published():
    cfg = ecapa.EcapaConfig(mel_dim=128, enc_dim=2048)
    p = ecapa.init_ecapa(cfg, torch.Generator().manual_seed(5), "cpu")
    return cfg, p


@pytest.fixture(scope="module")
def published():
    cfg, p = _published()
    jcfg = jecapa.EcapaConfig(mel_dim=128, enc_dim=2048)
    jp = jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(), p))
    jembed = jax.jit(lambda params, mel: jecapa.ecapa_embed(params, jcfg,
                                                            mel))
    return cfg, p, jp, jembed


@pytest.mark.parametrize("n", [24000, 777, 1024])
def test_speaker_mel_equals_jax(n):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = ecapa.qwen3_speaker_mel(audio * 0.1, n_mels=128)
    ref = jecapa.qwen3_speaker_mel(audio * 0.1, n_mels=128)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        ecapa.slaney_mel_filterbank(24000, 1024, 80, 0.0, 12000.0),
        jecapa.slaney_mel_filterbank(24000, 1024, 80, 0.0, 12000.0))


@pytest.mark.parametrize("B,T", [(1, 3), (1, 9), (2, 60)])
def test_ecapa_embed_matches_jax_at_published_widths(published, B, T):
    cfg, p, jp, jembed = published
    assert max((k - 1) * d // 2 for k, d in zip(cfg.kernel_sizes,
                                                 cfg.dilations)) == 4
    mel = np.random.default_rng(T).standard_normal((B, T, 128)
                                                   ).astype(np.float32)
    with torch.no_grad():
        got = ecapa.ecapa_embed(p, cfg, torch.from_numpy(mel)).numpy()
    ref = np.asarray(jembed(jp, jnp.asarray(mel)))
    assert got.shape == ref.shape == (B, 2048)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("T,pad", [(3, 4), (2, 7), (5, 2), (1, 3)])
def test_reflect_pad_past_the_signal_equals_jnp_pad(T, pad):
    x = np.random.default_rng(T).standard_normal((2, 3, T)
                                                 ).astype(np.float32)
    got = reflect_pad(torch.from_numpy(x), pad).numpy()
    ref = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (pad, pad)),
                             mode="reflect"))
    np.testing.assert_array_equal(got, ref)


def test_load_ecapa_params_matches_jax():
    cfg = ecapa.EcapaConfig(mel_dim=128, enc_dim=48,
                            channels=(32, 32, 32, 32, 96), se_channels=8,
                            attention_channels=8)
    p = ecapa.init_ecapa(cfg, torch.Generator().manual_seed(2), "cpu")
    state = synth.export_ecapa(p)
    got = ecapa.load_ecapa_params(state, cfg, device="cpu")
    ref = jecapa.load_ecapa_params({k: v.numpy() for k, v in state.items()},
                                   cfg)
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    assert_trees_equal(got, tparams.tree_map(lambda t: t.numpy(), p))
