"""Port parity, models: the talker backbone (prefill + decode over the paged
combined pool, a quantized int8 / float8 one, or the legacy pair), the
depth transformer, and a Qwen3-TTS ``lm_step`` with its 15-codebook
``depth_step`` under greedy sampling — each computed by the JAX package and
by the port from the same weights (converted with
``vox_serve_tpu_torch.params``), in float32 on the CPU at small widths.

Tolerances: 1e-4 absolute on hidden states of the layer stacks (float32,
several layers of matmuls summed in another order); sampled token ids must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.codecs.qwen3_codec import Qwen3CodecConfig as JCodecCfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import depth as jdepth
from vox_serve_tpu.models import qwen3_tts as jqwen3_mod
from vox_serve_tpu.models.qwen3_tts import Qwen3TTSLM as JQwen3
from vox_serve_tpu.ops import attention as jattn
from vox_serve_tpu.ops import kv_cache as jkv
from vox_serve_tpu.weights import DevTokenizer
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models import depth as tdepth
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.ops import attention as tattn
from vox_serve_tpu_torch.ops import kv_cache as tkv

torch.set_num_threads(1)
ATOL = 1e-4

BB = dict(vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qk_norm=True,
          rope_theta=1e6)
DEPTH = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True)
CODEC = dict(codebook_dim=32, codebook_size=2048, latent_dim=48,
             decoder_dim=64, hidden_size=32, intermediate_size=64,
             head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
             num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
             upsampling_ratios=(2, 2), vq_dim=16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _i(a):
    return torch.from_numpy(np.asarray(a, np.int32))


class Plan:
    """Host plan of one prefill (two packed segments) and decode steps over
    a small page pool, emitted as JAX and torch metadata."""

    def __init__(self, lens=(9, 5), page=4, P=16):
        self.lens, self.page, self.P = list(lens), page, P
        self.pages = [[1, 2, 3, 4], [5, 6, 7, 8]]
        self.seq = list(lens)

    def prefill(self):
        seg = np.concatenate([np.full(n, i) for i, n in enumerate(self.lens)])
        pos = np.concatenate([np.arange(n) for n in self.lens])
        pid = np.concatenate([np.asarray(self.pages[i])[np.arange(n)
                                                        // self.page]
                              for i, n in enumerate(self.lens)])
        arr = [a.astype(np.int32) for a in (pid, pos % self.page, seg, pos)]
        j = jattn.AttnMetadata(True, *map(jnp.asarray, arr[:2]),
                               segment_ids=jnp.asarray(arr[2]),
                               q_positions=jnp.asarray(arr[3]))
        t = tattn.AttnMetadata(True, *map(_i, arr[:2]),
                               segment_ids=_i(arr[2]),
                               q_positions=_i(arr[3]))
        last = np.cumsum(self.lens) - 1
        return j, t, arr[3], last.astype(np.int32)

    def decode(self):
        cur = np.asarray(self.seq)
        pid = np.asarray([self.pages[i][c // self.page]
                          for i, c in enumerate(cur)], np.int32)
        off = (cur % self.page).astype(np.int32)
        tables = np.asarray(self.pages, np.int32)
        seq = (cur + 1).astype(np.int32)
        self.seq = list(seq)
        j = jattn.AttnMetadata(False, jnp.asarray(pid), jnp.asarray(off),
                               block_tables=jnp.asarray(tables),
                               seq_lens=jnp.asarray(seq))
        t = tattn.AttnMetadata(False, _i(pid), _i(off),
                               block_tables=_i(tables), seq_lens=_i(seq))
        return j, t, cur.astype(np.int32)


def test_backbone_prefill_and_decode_match_jax():
    jcfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**BB, dtype=torch.float32)
    jp = jbb.init_backbone_params(jcfg, jax.random.key(0))
    tp = tparams.tree_to_torch(_np_tree(jp), "cpu", torch.float32)
    plan = Plan()
    shape = (2, plan.P, plan.page, 4, 16)
    jpool = jnp.zeros(shape, jnp.float32)
    tpool = torch.zeros(shape)
    rng = np.random.default_rng(0)

    jm, tm, pos, _ = plan.prefill()
    x = rng.standard_normal((len(pos), 64)).astype(np.float32)
    jh, jpool, _ = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos), jm, jpool, None)
    th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                              tpool)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)
    for _ in range(3):
        jm, tm, pos = plan.decode()
        x = rng.standard_normal((2, 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool,
                                            None)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos),
                                  tm, tpool)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("kv", ["int8", "f8_e4m3", "pair"])
def test_backbone_over_quantized_or_pair_kv_matches_jax(kv):
    """Prefill + 3 decode steps of the debug-size talker over each pool the
    slice adds, in both packages: hidden states agree and the pools hold
    the same K/V (the quantized ones byte for byte)."""
    combined = kv != "pair"
    quant = kv if combined else "none"
    plan = Plan()
    args = (2, plan.P, plan.page, BB["num_kv_heads"], BB["head_dim"])
    jc = jkv.KVCacheConfig(*args, dtype=jnp.float32, combined=combined,
                           quant=quant, k_amax=4.0, v_amax=4.0)
    tc = tkv.KVCacheConfig(*args, dtype=torch.float32, combined=combined,
                           quant=quant, k_amax=4.0, v_amax=4.0)
    jcfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**BB, dtype=torch.float32)
    jp = jbb.init_backbone_params(jcfg, jax.random.key(2))
    tp = tparams.tree_to_torch(_np_tree(jp), "cpu", torch.float32)
    jk, jv = jkv.alloc_kv_pages(jc)
    tk, tv = tkv.alloc_kv_pages(tc, "cpu")
    rng = np.random.default_rng(2)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jk, jv = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), jm, jk, jv,
                                          kv_scales=jc.kv_scales)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tk, tv, kv_scales=tc.kv_scales)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    if kv == "pair":
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    else:  # the JAX pool pads head dims to 128 lanes
        jb = np.asarray(jk).view(np.uint8)[..., :BB["head_dim"]]
        np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), jb)


def test_depth_forward_matches_jax():
    jcfg = jdepth.DepthConfig(**DEPTH, dtype=jnp.float32)
    tcfg = tdepth.DepthConfig(**DEPTH, dtype=torch.float32)
    jp = jdepth.init_depth_params(jcfg, jax.random.key(1))
    tp = tparams.tree_to_torch(_np_tree(jp), "cpu", torch.float32)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 2, 32)).astype(np.float32)
    x1 = rng.standard_normal((3, 1, 32)).astype(np.float32)
    jk, jv = jdepth.init_depth_kv(jcfg, 3)
    tk, tv = tdepth.init_depth_kv(tcfg, 3, "cpu")
    jh, jk, jv = jdepth.depth_forward(jp, jcfg, jnp.asarray(x0), 0, jk, jv)
    th = tdepth.depth_forward(tp, tcfg, torch.from_numpy(x0), 0, tk, tv)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    jh, jk, jv = jdepth.depth_forward(jp, jcfg, jnp.asarray(x1), 2, jk, jv)
    th = tdepth.depth_forward(tp, tcfg, torch.from_numpy(x1), 2, tk, tv)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)


class _JQwen3(JQwen3):
    """The JAX model with its weights supplied by the test (its own random
    init compiles ~90 XLA programs on the CPU)."""

    def _init_params(self):
        self.params, self.codec_params = {}, {}


@pytest.fixture(scope="module")
def qwen3_pair():
    tm = Qwen3TTSLM(dtype=torch.float32, device="cpu", seed=3,
                    debug_backbone=tbb.BackboneConfig(**BB,
                                                      dtype=torch.float32),
                    debug_depth=tdepth.DepthConfig(**DEPTH,
                                                   dtype=torch.float32),
                    debug_codec=Qwen3CodecConfig(**CODEC))
    np_params = jax.tree.map(lambda t: t.numpy(), tm.params)
    np_codec = jax.tree.map(lambda t: t.numpy(), tm.codec_params)
    # the JAX constructor looks for a real tokenizer first; the dev
    # tokenizer is what both packages serve without assets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqwen3_mod, "load_text_tokenizer",
                   lambda name, vocab: (DevTokenizer(vocab), False))
        jm = _JQwen3(dtype=jnp.float32,
                     debug_backbone=jbb.BackboneConfig(**BB,
                                                       dtype=jnp.float32),
                     debug_depth=jdepth.DepthConfig(**DEPTH,
                                                    dtype=jnp.float32),
                     debug_codec=JCodecCfg(**CODEC))
    jm.params = jax.tree.map(jnp.asarray, np_params)
    jm.codec_params = jax.tree.map(jnp.asarray, np_codec)
    tm.set_params(tparams.tree_to_torch(np_params, "cpu", torch.float32),
                  tparams.tree_to_torch(np_codec, "cpu", torch.float32))
    jm.sampling_config = jm.sampling_config.replace(greedy=True)
    tm.sampling_config = tm.sampling_config.replace(greedy=True)
    return jm, tm


@pytest.mark.parametrize("kw", [
    dict(prompt="hello there", language="english", speaker="ryan"),
    dict(prompt="abc", language="auto", speaker="serena",
         instruct="calm voice"),
    dict(streaming_first_token=1234, language="english", speaker="vivian"),
])
def test_qwen3_prompt_construction_matches_jax(qwen3_pair, kw):
    jm, tm = qwen3_pair
    a, b = jm.preprocess(**kw), tm.preprocess(**kw)
    np.testing.assert_array_equal(b.input_tokens, a.input_tokens)
    np.testing.assert_array_equal(b.input_masks, a.input_masks)
    np.testing.assert_array_equal(b.input_features, a.input_features)


def test_qwen3_lm_step_with_depth_greedy_matches_jax(qwen3_pair):
    """Prefill of two packed prompts, then two decode steps fed by the
    sampled tokens and the depth feedback: all 17 token columns equal."""
    jm, tm = qwen3_pair
    plan = Plan(lens=(0, 0), page=8, P=16)
    pos_list = [jm.preprocess(prompt=p, speaker="ryan", language="english")
                for p in ("hi", "yo!")]
    plan.lens = [len(po.input_tokens) for po in pos_list]
    plan.seq = list(plan.lens)
    plan.pages = [[1, 2, 3], [4, 5, 6]]
    toks = np.concatenate([po.input_tokens for po in pos_list])
    feats = np.concatenate([po.input_features for po in pos_list])
    masks = np.concatenate([po.input_masks for po in pos_list])
    shape = (2, plan.P, plan.page, 4, 16)
    jpool = jnp.zeros(shape, jnp.float32)
    tpool = torch.zeros(shape)
    rep = np.zeros((2, 1, 17, 3072), bool)

    jmeta, tmeta, pos, last = plan.prefill()
    jo = jm.lm_step(jm.params, jnp.asarray(toks), jnp.asarray(pos),
                    jnp.asarray(feats), jnp.asarray(masks), jmeta, jpool,
                    None, jax.random.key(0), jnp.asarray(rep),
                    last_token_idx=jnp.asarray(last))
    to = tm.lm_step(tm.params, _i(toks), _i(pos), torch.from_numpy(feats),
                    torch.from_numpy(masks), tmeta, tpool, None, None,
                    torch.from_numpy(rep), last_token_idx=_i(last))
    np.testing.assert_array_equal(to.sampled.numpy(), np.asarray(jo.sampled))
    np.testing.assert_allclose(to.feedback.numpy(), np.asarray(jo.feedback),
                               atol=ATOL)
    np.testing.assert_array_equal(to.repetition_cache.numpy(),
                                  np.asarray(jo.repetition_cache))
    jpool, jrep, trep = jo.k_pages, jo.repetition_cache, to.repetition_cache
    jfb, tfb = jo.feedback, to.feedback
    jtok, ttok = jo.sampled, to.sampled
    assert (ttok[:, -1] == 151671).all()  # text column: TTS_PAD

    for _ in range(2):
        jmeta, tmeta, pos = plan.decode()
        jo = jm.lm_step(jm.params, jtok, jnp.asarray(pos), jfb, None, jmeta,
                        jpool, None, jax.random.key(1), jrep)
        to = tm.lm_step(tm.params, ttok, _i(pos), tfb, None, tmeta, tpool,
                        None, None, trep)
        np.testing.assert_array_equal(to.sampled.numpy(),
                                      np.asarray(jo.sampled))
        np.testing.assert_allclose(to.feedback.numpy(),
                                   np.asarray(jo.feedback), atol=ATOL)
        jpool, jrep, trep = jo.k_pages, jo.repetition_cache, \
            to.repetition_cache
        jfb, tfb, jtok, ttok = jo.feedback, to.feedback, jo.sampled, \
            to.sampled


def test_qwen3_full_width_shapes_without_allocating():
    """The default (flagship) configuration has the published widths and
    about 1.9 B LM parameters (built on the meta device: no memory)."""
    m = Qwen3TTSLM(device="meta")
    bb, d, c = m.backbone_config, m.depth_config, m.codec_config
    assert (bb.num_layers, bb.hidden_size, bb.num_heads, bb.num_kv_heads,
            bb.resolved_head_dim, bb.intermediate_size) == (28, 2048, 16, 8,
                                                            128, 6144)
    assert (d.num_layers, d.hidden_size, d.max_seq) == (5, 1024, 17)
    assert c == Qwen3CodecConfig()
    assert bb.dtype == d.dtype == torch.bfloat16
    n_params = sum(a.numel() for a in tparams.tree_leaves(m.params))
    assert 1.85e9 < n_params < 1.95e9
    assert m.output_audio_length == 10 * 1920
