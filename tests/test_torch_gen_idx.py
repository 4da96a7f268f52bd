"""Port parity, the output-token index ``gen_idx`` (the port's
``BaseLM.lm_step`` -> ``embed_step`` and ``post_sample``, threaded by
vox_serve_tpu_torch/worker/base.py through every graph kind) against the
JAX worker, on the CPU.

A toy model (the dummy with a mask plane) reads ``gen_idx`` twice, as
Chatterbox and Zonos do: ``embed_step`` adds a learned row per output index
at decode (never at prefill, where the step has masks), and
``post_sample`` shifts each sampled id by its index. Greedy tokens are
exact, so any step that saw a wrong index (the prefill's zeros, the
single-step pack's column, the fused pack's ``gen_idx0 + i``) changes the
stream. The same stream comes out of the JAX worker's single-step path and
the port's single-step, fused k=4, chained (prefill, then the chained
first-chunk decode) and cold-chain paths, and differs from the stream of
the same model with ``gen_idx`` ignored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.sampling import SamplingConfig as JSamplingConfig
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

MAX_TOKENS = 40
ROWS = 48  # learned index rows (indices past them clip to the last)


def _with_masks(po):
    """A prompt whose mask plane takes no feature row (the step then has
    masks, as every prefill of a masked model does)."""
    po.input_masks = np.zeros((len(po.input_tokens), 1), bool)
    return po


class _GenIdxDummy(DummyLM):
    needs_input_masks = True
    use_gen_idx = True

    def preprocess(self, *a, **kw):
        return _with_masks(super().preprocess(*a, **kw))

    def embed_step(self, params, token_ids, features, masks, positions,
                   gen_idx):
        x = self.embed(params, token_ids, features, masks)
        if masks is None and gen_idx is not None and self.use_gen_idx:
            x = x + params["gpos"][torch.clamp(gen_idx.long(), 0, ROWS - 1)]
        return x

    def post_sample(self, params, hidden, ids, generator, gen_idx=None):
        if gen_idx is not None and self.use_gen_idx:
            ids = torch.remainder(ids + 3 * gen_idx[:, None].to(ids.dtype),
                                  self.vocab_size)
        return {"sampled": ids}


class _JGenIdxDummy(JDummyLM):
    needs_input_masks = True

    def preprocess(self, *a, **kw):
        return _with_masks(super().preprocess(*a, **kw))

    def embed_step(self, params, token_ids, features, masks, positions,
                   gen_idx):
        x = self.embed(params, token_ids, features, masks)
        if masks is None and gen_idx is not None:
            x = x + jnp.take(params["gpos"], jnp.clip(gen_idx, 0, ROWS - 1),
                             axis=0)
        return x

    def post_sample(self, params, hidden, ids, rng, gen_idx=None):
        if gen_idx is not None:
            ids = jnp.remainder(ids + 3 * gen_idx[:, None].astype(ids.dtype),
                                self.vocab_size)
        return {"sampled": ids}


def _models():
    tm = _GenIdxDummy(max_tokens=MAX_TOKENS)
    tm.params["gpos"] = torch.randn((ROWS, 64), generator=torch.Generator(
    ).manual_seed(4)) * 0.5
    tm.sampling_config = SamplingConfig(greedy=True, max_tokens=MAX_TOKENS)
    jm = _JGenIdxDummy(max_tokens=MAX_TOKENS)
    jm.params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tm.params)
    jm.sampling_config = JSamplingConfig(greedy=True, max_tokens=MAX_TOKENS)
    return tm, jm


KW = dict(max_batch_size=2, num_pages=64, page_size=8,
          max_prefill_requests=2)
CHAIN = dict(fused_decode_steps=4, fused_decode_buckets=(1,),
             first_chunk_frames=3)


def _stream(w, r, fused=False):
    w.run_lm_prefill([r])
    while not r.done_lm_generation:
        if fused and w.can_decode_multi([r], 4):
            w.run_lm_decode_multi([r], 4)
        else:
            w.run_lm_decode([r])
        w.sync()
    return np.stack(r.lm_output_tokens)


def _cold(w, r):
    assert w.can_cold_start(r)
    w.run_cold_start(r)
    w.sync()
    while not r.done_lm_generation:
        w.run_lm_decode([r])
        w.sync()
    return np.stack(r.lm_output_tokens)


@pytest.fixture(scope="module")
def reference():
    """The JAX worker's single-step stream, and the toy's stream with
    gen_idx ignored."""
    tm, jm = _models()
    jw = JWorker(jm, JWorkerConfig(prefill_token_buckets=(32,), warmup=False,
                                   **KW))
    ref = _stream(jw, JRequest(request_id="j", prompt="hello"))
    tm.use_gen_idx = False
    plain = _stream(ModelWorker(tm, WorkerConfig(prefill_token_buckets=(32,),
                                                 **KW)),
                    Request(request_id="p", prompt="hello"))
    assert len(ref) > 8
    assert not np.array_equal(ref[:len(plain)], plain[:len(ref)])
    return ref


@pytest.mark.parametrize("path", ["single", "fused", "chained", "cold"])
def test_gen_idx_reaches_every_graph_kind(reference, path):
    tm, _ = _models()
    if path == "single":
        w = ModelWorker(tm, WorkerConfig(prefill_token_buckets=(32,), **KW))
        got = _stream(w, Request(request_id="t", prompt="hello"))
    elif path == "fused":
        w = ModelWorker(tm, WorkerConfig(
            prefill_token_buckets=(32,), fused_decode_steps=4,
            fused_decode_buckets=(1,), **KW))
        got = _stream(w, Request(request_id="t", prompt="hello"),
                      fused=True)
        assert w.step_stats()["replays"]["decode_multi"] > 1
    else:
        # the chain in the smallest bucket; a prompt beyond it takes the
        # prefill, then the chained first-chunk decode
        buckets = (32, 128) if path == "cold" else (2, 128)
        w = ModelWorker(tm, WorkerConfig(prefill_token_buckets=buckets,
                                         **CHAIN, **KW))
        got = _cold(w, Request(request_id="t", prompt="hello"))
        kind = "cold_chain" if path == "cold" else "decode_multi_detok"
        assert w.step_stats()["replays"][kind] == 1
        assert w.cold_starts[{"cold": "chain",
                              "chained": "two_dispatch"}[path]] == 1
    np.testing.assert_array_equal(got, reference)
