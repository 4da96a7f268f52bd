"""Port parity, codec: the conv primitives and the streaming Qwen3-TTS
codec decoder against the JAX package on the same weights (the JAX init,
converted with ``vox_serve_tpu_torch.params``), float32 on the CPU at a
small width; and, within the port, chunked streaming == full decode.

Tolerances: 1e-5 absolute for single convolutions; 1e-4 for the codec's
waveform (a deep stack of convs and a transformer in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.codecs import layers as jlayers
from vox_serve_tpu.codecs import qwen3_codec as jcodec
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import layers as tlayers
from vox_serve_tpu_torch.codecs import qwen3_codec as tcodec

torch.set_num_threads(1)

SMALL = dict(codebook_dim=32, codebook_size=2048, latent_dim=48,
             decoder_dim=64, hidden_size=32, intermediate_size=64,
             head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
             num_quantizers=16, sliding_window=12, upsample_rates=(4, 3),
             upsampling_ratios=(2, 2), vq_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("groups,dilation,padding", [(1, 1, 0), (1, 3, 2),
                                                     (4, 1, (3, 0))])
def test_conv1d_matches_jax(groups, dilation, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 20)).astype(np.float32)
    p = {"w": rng.standard_normal((12, 8 // groups, 5)).astype(np.float32),
         "b": rng.standard_normal((12,)).astype(np.float32)}
    ref = jlayers.conv1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         padding=padding, dilation=dilation, groups=groups)
    got = tlayers.conv1d(jax.tree.map(_t, p), _t(x), padding=padding,
                         dilation=dilation, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stride,kernel", [(2, 2), (3, 6), (5, 10)])
def test_conv_transpose1d_matches_jax(stride, kernel):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 9)).astype(np.float32)
    p = {"w": rng.standard_normal((6, 4, kernel)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    ref = jlayers.conv_transpose1d(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), stride=stride)
    got = tlayers.conv_transpose1d(jax.tree.map(_t, p), _t(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def codec():
    jcfg = jcodec.Qwen3CodecConfig(**SMALL)
    tcfg = tcodec.Qwen3CodecConfig(**SMALL)
    jp = jcodec.init_qwen3_codec(jcfg, jax.random.key(7))
    tp = tparams.tree_to_torch(jax.tree.map(np.asarray, jp), "cpu",
                               torch.float32)
    codes = np.random.default_rng(2).integers(0, 2048, (2, 16, 30)).astype(
        np.int32)
    return jcfg, tcfg, jp, tp, codes


def test_codec_streaming_chunks_match_jax(codec):
    """Interval-sized streaming chunks (4 frames) through decode_chunk with
    the functional cache, in both packages: waveform and cache agree."""
    jcfg, tcfg, jp, tp, codes = codec
    jcache = jcodec.qwen3_codec_init_cache(jcfg, 2)
    tcache = tcodec.qwen3_codec_init_cache(tcfg, 2, "cpu")
    # one XLA program for every chunk (eager JAX compiles op by op)
    jchunk = jax.jit(jcodec.qwen3_codec_decode_chunk, static_argnums=1)
    for s in range(0, 16, 4):
        jw, jcache = jchunk(jp, jcfg, jnp.asarray(codes[:, :, s:s + 4]),
                            jcache)
        tw, tcache = tcodec.qwen3_codec_decode_chunk(
            tp, tcfg, _t(codes[:, :, s:s + 4]), tcache)
        assert tw.shape == (2, 1, 4 * tcfg.samples_per_frame)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4)
    np.testing.assert_allclose(tcache["attn_k"].numpy(),
                               np.asarray(jcache["attn_k"]), atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_codec_chunked_equals_full_within_port(codec):
    """Ring-sized chunks through decode_chunk reproduce the full decode
    exactly (the JAX package's own chunk == full property)."""
    _, tcfg, _, tp, codes = codec
    full = tcodec.qwen3_codec_decode(tp, tcfg, _t(codes))
    cache = tcodec.qwen3_codec_init_cache(tcfg, 2, "cpu")
    W = tcfg.sliding_window
    outs = []
    for s in range(0, codes.shape[-1], W):
        w, cache = tcodec.qwen3_codec_decode_chunk(
            tp, tcfg, _t(codes[:, :, s:s + W]), cache)
        outs.append(w)
    torch.testing.assert_close(torch.cat(outs, dim=-1), full, atol=0,
                               rtol=0)


def test_codec_cache_rows_are_per_slot(codec):
    """A batched cache decodes each row like a batch of one (the worker
    gathers and scatters slot rows along axis 0)."""
    _, tcfg, _, tp, codes = codec
    cache = tcodec.qwen3_codec_init_cache(tcfg, 2, "cpu")
    both, _ = tcodec.qwen3_codec_decode_chunk(tp, tcfg, _t(codes[:, :, :4]),
                                              cache)
    row = tparams.tree_map(lambda a: a[1:2], tcodec.qwen3_codec_init_cache(
        tcfg, 2, "cpu"))
    one, _ = tcodec.qwen3_codec_decode_chunk(tp, tcfg, _t(codes[1:, :, :4]),
                                             row)
    np.testing.assert_allclose(one.numpy(), both[1:].numpy(), atol=1e-5)
