"""Port parity, the Zonos speaker net
(vox_serve_tpu_torch/encoders/zonos_speaker.py) against the JAX package's
``encoders/zonos_speaker.py``, on the CPU in float32:

* ``log_fbank`` and ``resample_to_16k`` (host numpy) equal to JAX's at
  several lengths and rates;
* the forward (conv2d, eval-mode batch norms with random statistics,
  SimAM, the downsample branches, attentive-statistics pooling, the 256-d
  bottleneck, LDA to 128) at reduced widths and ``scale_blocks`` (2, 2, 2,
  1), 8 input planes: both outputs within 1e-4 of JAX's;
* ``extract_speaker_embedding`` from a 24 kHz synthetic WAV read by the
  port's reader (2.3 s: truncated to 2 s at 16 kHz) within 1e-4 of JAX's;
* ``load_zonos_speaker_params`` on the exporter's two ``torch.save`` files
  (all [10, 20, 64, 3] blocks, narrow planes) leaf for leaf equal to the
  JAX loader's and to the source.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from chip_smoke import synth_wav
from vox_serve_tpu.encoders import zonos_speaker as js
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import zonos_speaker as ts
from vox_serve_tpu_torch.models.zonos import SPEAKER_FILES
from vox_serve_tpu_torch.utils import load_audio_mono

torch.set_num_threads(1)
TOL = 1e-4
SMALL = dict(scale_blocks=(2, 2, 2, 1), in_planes=8)


def _np(tree):
    return tparams.tree_map(lambda t: t.detach().numpy(), tree)


def _small_params(seed=3):
    """Reduced widths with random batch-norm statistics and affines."""
    p = ts.init_zonos_speaker_params(torch.Generator().manual_seed(seed),
                                     "cpu", **SMALL)
    g = torch.Generator().manual_seed(seed + 1)

    def bns(tree):
        if isinstance(tree, dict):
            if "mean" in tree:
                c = tree["mean"].shape
                tree["mean"] = 0.1 * torch.randn(c, generator=g)
                tree["var"] = 0.5 + torch.rand(c, generator=g)
                tree["scale"] = 1 + 0.2 * torch.randn(c, generator=g)
                tree["bias"] = 0.1 * torch.randn(c, generator=g)
            else:
                for v in tree.values():
                    bns(v)
        elif isinstance(tree, list):
            for v in tree:
                bns(v)

    bns(p)
    return p


@pytest.mark.parametrize("n,sr", [(16000, 16000), (40000, 24000),
                                  (44100, 44100), (12345, 22050)])
def test_front_end_matches_jax(n, sr):
    wav = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    r_t, r_j = ts.resample_to_16k(wav, sr), js.resample_to_16k(wav, sr)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(ts.log_fbank(r_t), js.log_fbank(r_j))


def test_forward_matches_jax():
    p = _small_params()
    jp = jax.tree.map(jnp.asarray, _np(p))
    mel = ts.log_fbank(np.random.default_rng(0).standard_normal(
        24000).astype(np.float32)).astype(np.float32)
    emb, lda = ts.zonos_speaker_forward(p, torch.from_numpy(mel))
    jemb, jlda = js.zonos_speaker_forward(jp, jnp.asarray(mel))
    assert emb.shape == (256,) and lda.shape == (128,)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=TOL)
    np.testing.assert_allclose(lda.numpy(), np.asarray(jlda), atol=TOL)
    assert np.abs(np.asarray(jlda)).max() > 1e-3  # not a trivial output


def test_extract_from_a_wav_matches_jax(tmp_path):
    path = tmp_path / "ref.wav"
    path.write_bytes(synth_wav(55200, seed=1))  # 2.3 s at 24 kHz
    wav, sr = load_audio_mono(str(path), target_sr=None, return_sr=True)
    assert sr == 24000
    p = _small_params(seed=5)
    got = ts.extract_speaker_embedding(p, wav, sr)
    ref = js.extract_speaker_embedding(jax.tree.map(jnp.asarray, _np(p)),
                                       wav, sr)
    assert got.dtype == np.float32 and got.shape == (128,)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


def test_loader_on_the_exporters_files(tmp_path):
    src = ts.init_zonos_speaker_params(torch.Generator().manual_seed(7),
                                       "cpu", in_planes=4)
    sizes = synth.write_zonos_speaker(tmp_path, src)
    assert set(sizes) == set(SPEAKER_FILES)
    sd, lda = (torch.load(tmp_path / f, weights_only=True)
               for f in SPEAKER_FILES)
    got = ts.load_zonos_speaker_params(sd, lda)
    ref = js.load_zonos_speaker_params({k: v.numpy() for k, v in sd.items()},
                                       {k: v.numpy() for k, v in lda.items()})
    g, r, s = (jax.tree.leaves_with_path(t) for t in
               (_np(got), jax.tree.map(np.asarray, ref), _np(src)))
    assert [k for k, _ in g] == [k for k, _ in r] == [k for k, _ in s]
    assert len(g) > 1000  # every one of the 97 blocks
    for (k, a), (_, b), (_, c) in zip(g, r, s):
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))
        np.testing.assert_array_equal(a, c, err_msg=str(k))
    # without the LDA file: the bottleneck's 256-d output
    assert "lda" not in ts.load_zonos_speaker_params(sd)
