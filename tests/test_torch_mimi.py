"""Port parity, the Mimi codec (vox_serve_tpu_torch/codecs/mimi.py) against
the JAX package's, on the CPU at the small widths of the JAX CSM test
(``SMALL_MIMI``: 2 x 16 transformer, window 6, SEANet rates 4, 3), the
same weights in both packages (JAX params converted by ``tree_to_torch``),
codes and audio from numpy seeds.

Tolerances:
- float32 decode, whole and streamed, and each chunk's cache: 1e-5 of max
  |reference| (measured ~1e-6: the same float32 math in another summation
  order);
- streamed chunks against the port's own whole decode: 1e-5 of max |whole|
  (position-exact masks, so the two differ only by summation order);
- the bf16 codec (params and cache cast as each worker casts them): the
  port's max |error| against the JAX float32 decode at most 1.25x the JAX
  bf16 codec's plus 2^-9 of max |f32 output|;
- ``mimi_encode``: codes exactly equal (a nearest-centroid argmin over the
  same float32 distances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.codecs import mimi as jmimi
from vox_serve_tpu_torch.codecs import mimi as tmimi
from vox_serve_tpu_torch.codecs.layers import causal_conv, rvq_decode
from vox_serve_tpu_torch.params import tree_leaves, tree_map, tree_to_torch

torch.set_num_threads(1)

SMALL = dict(n_codebooks=32, codebook_size=2048, vq_dim=8, num_filters=8,
             upsample_ratios=(4, 3), hidden_size=16, intermediate_size=32,
             head_dim=8, num_heads=2, num_kv_heads=2, num_layers=2,
             sliding_window=6)
JCFG, TCFG = jmimi.MimiConfig(**SMALL), tmimi.MimiConfig(**SMALL)
REL = 1e-5
CODEC_FACTOR, CODEC_SLACK = 1.25, 2.0 ** -9
# the JAX functions jitted once (op-by-op dispatch would dominate the run)
jdecode = jax.jit(lambda p, codes, cache: jmimi.mimi_decode_chunk(
    p, JCFG, codes, cache))
jencode = jax.jit(lambda e, p, audio: jmimi.mimi_encode(e, p, JCFG, audio))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda k: jmimi.init_mimi(JCFG, k))(jax.random.key(0))
    return jp, tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _codes(B=2, T=8, seed=0):
    return np.random.default_rng(seed).integers(0, 2048, (B, 32, T)
                                                ).astype(np.int32)


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max()


def test_default_config_matches_jax():
    assert tmimi.MimiConfig() == tmimi.MimiConfig(**{
        f: getattr(jmimi.MimiConfig(), f)
        for f in jmimi.MimiConfig.__dataclass_fields__})
    assert tmimi.MimiConfig().frame_samples == 1920
    assert tmimi.MimiConfig().seanet_in == 1024


def test_init_shapes_match_jax():
    g = torch.Generator().manual_seed(0)
    tp = tmimi.init_mimi(TCFG, g, "cpu")
    te = tmimi.init_mimi_encoder(TCFG, g, "cpu")
    key = jax.random.key(0)
    jp = jax.eval_shape(lambda k: jmimi.init_mimi(JCFG, k), key)
    je = jax.eval_shape(lambda k: jmimi.init_mimi_encoder(JCFG, k), key)
    for jt, tt in ((jp, tp), (je, te)):
        shapes = []
        tree_map(lambda a, b: shapes.append((tuple(a.shape), tuple(b.shape))),
                 jt, tt)
        assert shapes and all(a == b for a, b in shapes)
    cache = tmimi.mimi_init_cache(TCFG, 3, "cpu")
    jcache = jmimi.mimi_init_cache(JCFG, 3)
    same = []
    tree_map(lambda a, b: same.append(
        (tuple(a.shape), str(a.dtype))
        == (tuple(b.shape), str(b.dtype).removeprefix("torch."))),
        jax.tree.map(np.asarray, jcache), cache)
    assert len(same) == 11 and all(same)
    assert cache["pos"].dtype == cache["attn_len"].dtype == torch.int32


def test_decode_whole_matches_jax(params):
    jp, tp = params
    codes = _codes()
    ref, none = jdecode(jp, jnp.asarray(codes), None)
    got, cache = tmimi.mimi_decode_chunk(tp, TCFG, torch.from_numpy(codes),
                                         None)
    assert none is None and cache is None
    assert tuple(got.shape) == (2, 1, 8 * TCFG.frame_samples)
    assert _rel(got.numpy(), ref) <= REL


def test_streamed_chunks_and_caches_match_jax(params):
    """2-frame chunks (4 transformer tokens each; the 6-token window fills
    and then slides) through both packages' caches."""
    jp, tp = params
    codes = _codes(seed=1)
    whole, _ = tmimi.mimi_decode_chunk(tp, TCFG, torch.from_numpy(codes),
                                       None)
    jcache = jmimi.mimi_init_cache(JCFG, 2)
    tcache = tmimi.mimi_init_cache(TCFG, 2, "cpu")
    outs = []
    for s in range(0, 8, 2):
        chunk = codes[:, :, s:s + 2]
        ref, jcache = jdecode(jp, jnp.asarray(chunk), jcache)
        got, tcache = tmimi.mimi_decode_chunk(tp, TCFG,
                                              torch.from_numpy(chunk), tcache)
        assert _rel(got.numpy(), ref) <= REL
        pairs = []
        tree_map(lambda a, b: pairs.append((np.asarray(a), b.numpy())),
                 jcache, tcache)
        assert len(pairs) == 11
        for a, b in pairs:
            assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, a)
            else:
                assert np.abs(b - a).max() <= REL * max(np.abs(a).max(), 1e-3)
        outs.append(got)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [16, 16])
    np.testing.assert_array_equal(tcache["attn_len"].numpy(), [6, 6])
    assert _rel(torch.cat(outs, -1).numpy(), whole.numpy()) <= REL


def test_rows_are_independent(params):
    """A row's output does not depend on the other rows of its batch (the
    worker pads detokenize batches with a sentinel row)."""
    _, tp = params
    codes = _codes(B=3, T=4, seed=2)
    cache = tmimi.mimi_init_cache(TCFG, 3, "cpu")
    cache["pos"][1] = 57  # another row far along its stream
    cache["attn_len"][1] = 6
    cache["attn_k"][1].normal_()
    both, _ = tmimi.mimi_decode_chunk(tp, TCFG, torch.from_numpy(codes),
                                      cache)
    alone, _ = tmimi.mimi_decode_chunk(
        tp, TCFG, torch.from_numpy(codes[[0, 2]]),
        tree_map(lambda a: a[[0, 2]], cache))
    assert _rel(both[[0, 2]].numpy(), alone.numpy()) <= REL


def _cast(tree, cast):
    return tree_map(lambda a: cast(a) if a.dtype == torch.float32 else a,
                    tree)


def test_bf16_codec_is_as_close_to_f32_as_jax_bf16(params):
    jp, tp = params
    codes = _codes(seed=3)
    f32, _ = jdecode(jp, jnp.asarray(codes), None)
    f32 = np.asarray(f32)

    def jcast(tree):
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                            if a.dtype == jnp.float32 else a, tree)

    jb_params = jcast(jp)
    tb_params = _cast(tp, lambda a: a.to(torch.bfloat16))
    jcache, tcache = (jcast(jmimi.mimi_init_cache(JCFG, 2)),
                      _cast(tmimi.mimi_init_cache(TCFG, 2, "cpu"),
                            lambda a: a.to(torch.bfloat16)))
    jouts, touts = [], []
    for s in range(0, 8, 4):
        chunk = codes[:, :, s:s + 4]
        a, new = jdecode(jb_params, jnp.asarray(chunk), jcache)
        jcache = jax.tree.map(lambda x, r: x.astype(r.dtype), new, jcache)
        b, new = tmimi.mimi_decode_chunk(tb_params, TCFG,
                                         torch.from_numpy(chunk), tcache)
        tcache = tree_map(lambda x, r: x.to(r.dtype), new, tcache)
        assert b.dtype == torch.bfloat16
        jouts.append(np.asarray(a.astype(jnp.float32)))
        touts.append(b.float().numpy())
    jb, tb = np.concatenate(jouts, -1), np.concatenate(touts, -1)
    assert tb.shape == f32.shape and np.isfinite(tb).all()
    scale = np.abs(f32).max()
    err_jax, err_port = np.abs(jb - f32).max(), np.abs(tb - f32).max()
    assert 0 < err_jax
    assert err_port <= CODEC_FACTOR * err_jax + CODEC_SLACK * scale


@pytest.mark.parametrize("samples", [5 * 24, 7 * 24 + 5])
def test_encode_codes_equal_jax(params, samples):
    jp, tp = params
    je = jax.jit(lambda k: jmimi.init_mimi_encoder(JCFG, k))(
        jax.random.key(3))
    te = tree_to_torch(jax.tree.map(np.asarray, je), "cpu")
    audio = (np.random.default_rng(samples).standard_normal((2, samples))
             * 0.3).astype(np.float32)
    ref = np.asarray(jencode(je, jp, jnp.asarray(audio)))
    got = tmimi.mimi_encode(te, tp, TCFG, torch.from_numpy(audio))
    assert got.dtype == torch.int32 and got.shape[1] == 32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_encoder_without_codebooks_reads_the_decoders(params):
    """The encoder takes its codebooks from the decoder's params when it
    has none of its own (plain Mimi shares them)."""
    _, tp = params
    g = torch.Generator().manual_seed(4)
    enc = tmimi.init_mimi_encoder(TCFG, g, "cpu")
    audio = torch.randn((1, 4 * 24), generator=g) * 0.3
    own = tmimi.mimi_encode(enc, tp, TCFG, audio)
    shared = {k: v for k, v in enc.items() if not k.startswith("rvq_")}
    tied = {**enc, "rvq_first": {k: tp["rvq_first"][k]
                                 for k in ("embed_sum", "usage")},
            "rvq_rest": {k: tp["rvq_rest"][k]
                         for k in ("embed_sum", "usage")}}
    np.testing.assert_array_equal(
        tmimi.mimi_encode(shared, tp, TCFG, audio).numpy(),
        tmimi.mimi_encode(tied, None, TCFG, audio).numpy())
    assert own.shape == (1, 32, 4)


def test_shared_layers_helpers():
    """``causal_conv`` streamed equals whole, and ``rvq_decode`` sums the
    group's dequantized entries before its projection."""
    g = torch.Generator().manual_seed(5)
    p = {"w": torch.randn((4, 3, 3), generator=g), "b": torch.zeros(4)}
    x = torch.randn((2, 3, 10), generator=g)
    whole, none = causal_conv(p, x, 2, None)
    a, c = causal_conv(p, x[..., :6], 2, torch.zeros((2, 3, 2)))
    b, c2 = causal_conv(p, x[..., 6:], 2, c)
    assert none is None and tuple(c2.shape) == (2, 3, 2)
    torch.testing.assert_close(torch.cat([a, b], -1), whole)
    grp = {"embed_sum": torch.randn((2, 5, 3), generator=g),
           "usage": torch.full((2, 5), 2.0),
           "out_proj": {"w": torch.eye(3)[:, :, None]}}
    codes = torch.tensor([[[1, 4], [0, 2]]])
    want = (grp["embed_sum"][0, [1, 4]] + grp["embed_sum"][1, [0, 2]]) / 2.0
    torch.testing.assert_close(rvq_decode(grp, codes)[0], want.T)
    assert len(tree_leaves(grp)) == 3
