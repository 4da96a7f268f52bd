"""Port parity, the codec served at ``codec_dtype="bfloat16"`` on the CPU:
K2's bf16 plain version (``fused_resunit_stack_plain`` on bf16 inputs)
against the JAX package's Pallas ``fused_resunit_stack`` in interpret mode
and against the Pallas kernel's own body run outside Pallas; the port's
bf16 Qwen3 codec and the JAX package's, each cast by its worker, held
against the JAX float32 codec; and the worker's cast of every codec
parameter and cache tensor, with a detokenize through it.

Tolerances (relative to max |reference|):
- K2 bf16 plain vs the Pallas kernel's body outside Pallas: one bf16 step
  of the top binade, 2^-8 (the same rounding points, with float32 sums in
  another order; measured 0 at C=96);
- K2 bf16 plain vs the Pallas kernel in interpret mode: 2^-6 (interpret
  mode's dots round elsewhere; measured 2.9e-3 at C=96);
- the bf16 codec: the port's max |error| against the JAX float32 output at
  most 1.25x the JAX bf16 codec's plus 2^-9 of max |f32 output| (measured:
  equal to the JAX bf16 codec's error, unfused and fused).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _qwen3_pair
from test_torch_worker_decode import debug_qwen3
from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.ops import pallas_resunit as jres
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.ops import resunit
from vox_serve_tpu_torch.params import tree_leaves
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

REL_KERNEL_BODY = 2.0 ** -8
REL_INTERPRET = 2.0 ** -6
CODEC_FACTOR, CODEC_SLACK = 1.25, 2.0 ** -9


def _units(rng, C):
    def conv(k):
        s = 1 / np.sqrt(C * k)
        return {"w": rng.uniform(-s, s, (C, C, k)).astype(np.float32),
                "b": rng.uniform(-s, s, (C,)).astype(np.float32)}

    def small():
        return (rng.standard_normal(C) * 0.2).astype(np.float32)

    return [{"alpha1": small(), "beta1": small(), "conv1": conv(7),
             "alpha2": small(), "beta2": small(), "conv2": conv(1)}
            for _ in range(3)]


def _bf16_case(C, B, T, seed):
    """The same bf16 units, x and caches in both packages (float32 draws,
    rounded to bf16 once)."""
    rng = np.random.default_rng(seed)
    units = _units(rng, C)
    x = (rng.standard_normal((B, C, T)) * 0.5).astype(np.float32)
    caches = [(rng.standard_normal((B, C, 6 * d)) * 0.5).astype(np.float32)
              for d in (1, 3, 9)]
    ju = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), units)
    tu = tparams.tree_to_torch(units, "cpu", torch.bfloat16)
    return (ju, jnp.asarray(x).astype(jnp.bfloat16),
            [jnp.asarray(c).astype(jnp.bfloat16) for c in caches],
            tu, torch.from_numpy(x).to(torch.bfloat16),
            [torch.from_numpy(c).to(torch.bfloat16) for c in caches])


def _kernel_body(x, units, caches):
    """The Pallas kernel's body (pallas_resunit.py ``_kernel``) run outside
    Pallas, one batch row at a time, with numpy arrays as its refs: the
    kernel's rounding points in XLA's CPU arithmetic."""
    B, C, T = x.shape
    packed = [np.asarray(p) for p in jres._pack_params(units, C, C,
                                                       dtype=jnp.bfloat16)]
    outs, ncs = [], [[], [], []]
    for b in range(B):
        x_ref = np.asarray(x[b:b + 1].transpose(0, 2, 1))
        c_refs = [np.asarray(
            jnp.zeros((1, 6 * d, C), jnp.bfloat16) if caches is None
            else caches[u][b:b + 1].transpose(0, 2, 1))
            for u, d in enumerate((1, 3, 9))]
        out = np.zeros_like(x_ref)
        nc = [np.zeros_like(c) for c in c_refs]
        ypad = np.zeros((T + 54, C), x_ref.dtype)
        jres._kernel(x_ref, c_refs, *packed, out, nc, ypad,
                     dilations=(1, 3, 9), T=T, C=C)
        outs.append(out[0].T)
        for u in range(3):
            ncs[u].append(nc[u][0].T)
    return np.stack(outs), [np.stack(n) for n in ncs]


def _rel(got: torch.Tensor, ref) -> float:
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - r).max() / np.abs(r).max())


# the debug codec's two block widths (decoder_dim 64 / 2, / 4), and the
# served codec's narrowest (96)
@pytest.mark.parametrize("C,T", [(32, 64), (16, 192), (96, 80)])
@pytest.mark.parametrize("with_caches", [False, True])
def test_k2_bf16_plain_matches_pallas(C, T, with_caches):
    ju, jx, jc, tu, tx, tc = _bf16_case(C, 2, T, C + T)
    out, new = resunit.fused_resunit_stack(tx, tu, tc if with_caches
                                           else None)
    assert out.dtype == torch.bfloat16
    ref, jnew = jres.fused_resunit_stack(jx, ju, jc if with_caches else None,
                                         interpret=True)
    assert _rel(out, ref) <= REL_INTERPRET
    body, bnew = _kernel_body(jx, ju, jc if with_caches else None)
    assert _rel(out, body) <= REL_KERNEL_BODY
    if with_caches:
        for a, b, c in zip(new, jnew, bnew):
            assert a.dtype == torch.bfloat16
            assert _rel(a, b) <= REL_INTERPRET
            assert _rel(a, c) <= REL_KERNEL_BODY
    else:
        assert new == [None] * 3


def test_k2_bf16_plain_streamed_chunks_equal_whole():
    """Two chunks through the caches give the whole signal's output (the
    cache is the last 6*dil snaked samples, rounded to bf16 as the conv
    reads them)."""
    _, _, _, tu, tx, tc = _bf16_case(32, 2, 140, 5)
    whole, wc = resunit.fused_resunit_stack(tx, tu, tc)
    a, ca = resunit.fused_resunit_stack(tx[..., :70], tu, tc)
    b, cb = resunit.fused_resunit_stack(tx[..., 70:], tu, ca)
    torch.testing.assert_close(torch.cat([a, b], -1), whole, rtol=0, atol=0)
    for x, y in zip(cb, wc):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_pack_unit_keys_by_dtype():
    """One parameter set packs once per kernel type, and each type's
    packing is kept: float32 into TF32 hi/lo planes, bf16 into one bf16
    plane (k, C/8, C, 8)."""
    _, _, _, tu, _, _ = _bf16_case(16, 1, 64, 2)
    p = tu[0]
    n = resunit.pack_unit.count
    f = resunit.pack_unit(p, torch.float32)
    h = resunit.pack_unit(p, torch.bfloat16)
    assert resunit.pack_unit(p, torch.float32) is f
    assert resunit.pack_unit(p, torch.bfloat16) is h
    assert resunit.pack_unit.count == n + 2
    assert f.w1.dtype == torch.float32 and tuple(f.w1.shape) == (2, 7, 4, 16,
                                                                 4)
    assert h.w1.dtype == torch.bfloat16 and tuple(h.w1.shape) == (7, 2, 16, 8)
    w = p["conv1"]["w"]
    for tap in range(7):
        for c8 in range(2):
            torch.testing.assert_close(
                h.w1[tap, c8], w[:, 8 * c8:8 * c8 + 8, tap], rtol=0, atol=0)
    assert h.af1.dtype == torch.float32  # snake constants stay float32


# ---------------------------------------------------------------------------
# the bf16 codec, cast by each package's worker
# ---------------------------------------------------------------------------

SPANS = ((0, 4), (4, 4), (8, 4))  # three streamed chunks of frames


def _cast_back(new, ref):
    """A chunk's new cache at the slot cache's dtype, as the worker stores
    it between chunks."""
    return jax.tree.map(lambda a, b: a.astype(b.dtype), new, ref)


def _jax_stream(model, params, tokens, cache0):
    detok = jax.jit(model.detokenize)  # one trace per dtype, not per op
    cache, outs = cache0, []
    for s, n in SPANS:
        wav, new = detok(params, jnp.asarray(tokens[:, s:s + n]), cache)
        cache = _cast_back(new, cache0)
        outs.append(np.asarray(jnp.asarray(wav).astype(jnp.float32)))
    return np.concatenate(outs, -1)


def _port_stream(model, params, tokens, cache0):
    cache, outs = cache0, []
    for s, n in SPANS:
        wav, new = model.detokenize(params,
                                    torch.from_numpy(tokens[:, s:s + n]),
                                    cache)
        cache = tparams.tree_map(lambda a, b: a.to(b.dtype), new, cache0)
        outs.append(wav.float().numpy())
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_codec_is_as_close_to_f32_as_jax_bf16(fused, monkeypatch):
    if fused:
        monkeypatch.setenv("VOX_FUSED_RESUNIT", "1")
    jm, tm = _qwen3_pair(max_tokens=40)
    B = 2
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 2048, (B, 13, 17)).astype(np.int32)
    f32 = _jax_stream(jm, jm.codec_params, tokens, jm.init_decoder_cache(B))
    kw = dict(max_batch_size=B, num_pages=64, page_size=8,
              prefill_token_buckets=(128,), codec_dtype="bfloat16")
    JWorker(jm, JWorkerConfig(warmup=False, **kw))
    tw = ModelWorker(tm, WorkerConfig(**kw))
    assert tw.codec_dtypes() == ["bfloat16"]
    jb = _jax_stream(jm, jm.codec_params, tokens, jm.init_decoder_cache(B))
    tb = _port_stream(tm, tm.codec_params, tokens, tm.init_decoder_cache(B))
    assert tb.shape == f32.shape == jb.shape and np.isfinite(tb).all()
    scale = np.abs(f32).max()
    err_jax = np.abs(jb - f32).max()
    err_port = np.abs(tb - f32).max()
    assert 0 < err_jax  # the bf16 codec does round
    assert err_port <= CODEC_FACTOR * err_jax + CODEC_SLACK * scale


def _bf16_worker(model):
    return ModelWorker(model, WorkerConfig(
        max_batch_size=2, num_pages=1200, page_size=8,
        prefill_token_buckets=(128,), max_prefill_requests=2,
        codec_dtype="bfloat16"))


@pytest.mark.parametrize("name", ["dummy", "qwen3"])
def test_worker_casts_every_codec_tensor_before_the_cache(name):
    """Every floating codec parameter and slot-cache tensor is bf16, the
    cache built from the cast (integer leaves, the codec's positions,
    stay as they are); models made later get bf16 caches too."""
    model = DummyLM(max_tokens=40) if name == "dummy" else debug_qwen3()
    w = _bf16_worker(model)
    floats = [a for a in tree_leaves([model.codec_params, w.codec_cache])
              if a.is_floating_point()]
    assert floats and all(a.dtype == torch.bfloat16 for a in floats)
    assert w.codec_dtypes() == ["bfloat16"]
    assert all(a.dtype == torch.bfloat16
               for a in tree_leaves(model.init_decoder_cache(1))
               if a.is_floating_point())
    ints = [a for a in tree_leaves(w.codec_cache)
            if not a.is_floating_point()]
    assert all(a.dtype == torch.int32 for a in ints)


def test_worker_without_codec_dtype_keeps_float32():
    w = ModelWorker(DummyLM(max_tokens=40), WorkerConfig(
        max_batch_size=2, num_pages=32, page_size=8,
        prefill_token_buckets=(64,)))
    assert w.codec_dtypes() == ["float32"]


@pytest.mark.parametrize("name", ["dummy", "qwen3"])
def test_bf16_codec_detokenize_gives_pcm(name):
    """The JAX package's test_codec_dtype_bf16, on the port's worker: one
    request's first window through the bf16 codec gives finite, non-empty
    PCM, as the JAX worker's does."""
    model = DummyLM(max_tokens=40) if name == "dummy" else debug_qwen3()
    w = _bf16_worker(model)
    req = Request(request_id="bf16", prompt="hello",
                  sampling_config=SamplingConfig(max_tokens=40))
    w.run_lm_prefill([req])
    iv = model.detokenize_interval
    while len(req.lm_output_audio_tokens) < iv and not req.done_lm_generation:
        w.run_lm_decode([req])
    w.sync()
    req.next_audio_decode_idx = [0]
    w.run_detokenize([req])
    w.flush_detokenize()
    pcm = b""
    while not req.output_audio.empty():
        pcm += req.output_audio.get()
    x = np.frombuffer(pcm, np.int16)
    assert x.size > 0 and np.abs(x).max() > 0
    if name == "dummy":
        # the JAX worker's bf16 dummy codec on the same tokens: within 2
        # int16 steps per bf16 phase step (a bf16 phase cache rounds the
        # carried phase to 2^-7 of its binade: none in a first window)
        jm = JDummyLM(max_tokens=40)
        jw = JWorker(jm, JWorkerConfig(
            max_batch_size=2, num_pages=64, page_size=8,
            prefill_token_buckets=(64,), max_prefill_requests=2,
            warmup=False, codec_dtype="bfloat16"))
        jr = JRequest(request_id="j", prompt="hello")
        jw.run_lm_prefill([jr])
        jw.sync()
        jr.lm_output_audio_tokens = list(req.lm_output_audio_tokens)
        jr.next_audio_decode_idx = [0]
        jw.run_detokenize([jr])
        jw.flush_detokenize()
        jw.sync()
        jpcm = b""
        while not jr.output_audio.empty():
            jpcm += jr.output_audio.get()
        y = np.frombuffer(jpcm, np.int16)
        assert y.shape == x.shape
        assert np.abs(x.astype(np.int32) - y).max() <= 2
