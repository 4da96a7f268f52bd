"""Port parity, fused and pipelined decode through the schedulers, on the
CPU: the port's fused k-step decode and its readback pipeline give exactly
the greedy tokens and audio bytes of its single-step synchronous path, for
``dummy`` and a debug-width Qwen3-TTS, under ``Scheduler`` and
``OnlineScheduler`` (as tests/test_fused_decode.py holds the JAX worker).
One exception, which is the codec's and not the decode's: where the online
scheduler finds two windows of a Qwen3 stream ready at once (fused rounds
make four frames at a time), the worker decodes them as one catch-up
window, whose float32 sums round differently from two streamed windows
(measured: 2 int16 steps), so there the audio is held to 4 steps. And the
port's worker gives exactly the JAX worker's greedy tokens at the same
config and weights (fused k=4, pipeline depth 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_worker_decode import debug_qwen3
from vox_serve_tpu.codecs.qwen3_codec import Qwen3CodecConfig as JCodecCfg
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.models import depth as jdepth
from vox_serve_tpu.models import qwen3_tts as jqwen3_mod
from vox_serve_tpu.models.qwen3_tts import Qwen3TTSLM as JQwen3
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.weights import DevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)


def _drive(sched, reqs, max_steps=300):
    for r in reqs:
        sched.enqueue_request(r)
    for _ in range(max_steps):
        sched._step()
        if all(r.done_all for r in reqs):
            break
    return sched._inproc_results


def _audio(msgs, rid):
    return b"".join(m.split(b"|", 2)[2] for m in msgs
                    if m.startswith(rid.encode() + b"|")
                    and m.split(b"|")[1] == b"AUDIO")


def _model(name):
    if name == "dummy":
        m = DummyLM(max_tokens=20)
        m.sampling_config = SamplingConfig(greedy=True, max_tokens=20)
        return m
    m = debug_qwen3()
    m.sampling_config = m.sampling_config.replace(greedy=True,
                                                  max_tokens=44)
    return m


def _serve(name, sched_type, n_req=2, **kw):
    """Serve n_req streams; returns tokens and audio per request and the
    worker."""
    w = ModelWorker(_model(name), WorkerConfig(
        max_batch_size=4, num_pages=1200, page_size=8,
        prefill_token_buckets=(128,), max_prefill_requests=4, **kw))
    s = load_scheduler(sched_type, model_worker=w, max_batch_size=4,
                       connect=False)
    reqs = [Request(request_id=f"s{i}", prompt=f"stream number {i}",
                    is_streaming=True, is_pressing=True)
            for i in range(n_req)]
    msgs = _drive(s, reqs)
    out = []
    for r in reqs:
        assert r.done_all, r
        out.append(([tuple(int(x) for x in t) for t in r.lm_output_tokens],
                    _audio(msgs, r.request_id)))
        assert out[-1][1], "no audio"
        assert r.slot is None and not r.kv_pages
        assert r.extras.get("inflight", 0) == 0
    assert w.allocator.num_free == 1199 and w.allocator._reserved == 0
    assert sorted(w._free_slots) == [0, 1, 2, 3]
    assert not w._pending
    return out, w


@pytest.mark.parametrize("name", ["dummy", "qwen3"])
@pytest.mark.parametrize("sched_type", ["base", "online"])
def test_fused_decode_matches_single_step(name, sched_type):
    single, _ = _serve(name, sched_type)
    fused, w = _serve(name, sched_type, fused_decode_steps=4,
                      fused_decode_buckets=(2,))
    assert w.step_stats()["replays"].get("decode_multi", 0) > 0
    assert [t for t, _ in fused] == [t for t, _ in single]
    for (_, a), (_, b) in zip(fused, single):
        if name == "qwen3" and sched_type == "online":
            assert len(a) == len(b)
            diff = np.abs(np.frombuffer(a, np.int16).astype(np.int32)
                          - np.frombuffer(b, np.int16))
            assert diff.max() <= 4
        else:
            assert a == b


@pytest.mark.parametrize("name", ["dummy", "qwen3"])
def test_pipeline_depth_keeps_tokens_and_audio(name):
    """Three streams (the scheduler syncs at two or fewer), fused and
    pipelined against single-step and synchronous."""
    sync, _ = _serve(name, "online", n_req=3)
    piped, w = _serve(name, "online", n_req=3, pipeline_depth=2)
    assert w.max_pending >= 2
    both, w2 = _serve(name, "online", n_req=3, pipeline_depth=2,
                      fused_decode_steps=4, fused_decode_buckets=(4,))
    assert w2.max_pending >= 2
    assert w2.step_stats()["replays"].get("decode_multi", 0) > 0
    assert piped == sync
    assert both == sync


# -- the port against the JAX worker -----------------------------------

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


class _JQwen3(JQwen3):
    """The JAX model with its weights supplied by the test."""

    def _init_params(self):
        self.params, self.codec_params = {}, {}


def _qwen3_pair(max_tokens):
    """The debug Qwen3 in both packages with the same weights, greedy."""
    tm = debug_qwen3(seed=3)
    np_params = jax.tree.map(lambda t: t.numpy(), tm.params)
    np_codec = jax.tree.map(lambda t: t.numpy(), tm.codec_params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqwen3_mod, "load_text_tokenizer",
                   lambda name, vocab: (DevTokenizer(vocab), False))
        jm = _JQwen3(dtype=jnp.float32, detokenize_interval=4,
                     debug_backbone=jbb.BackboneConfig(**BB,
                                                       dtype=jnp.float32),
                     debug_depth=jdepth.DepthConfig(**DEPTH,
                                                    dtype=jnp.float32),
                     debug_codec=JCodecCfg(**CODEC))
    jm.params = jax.tree.map(jnp.asarray, np_params)
    jm.codec_params = jax.tree.map(jnp.asarray, np_codec)
    tm.set_params(tparams.tree_to_torch(np_params, "cpu", torch.float32),
                  tparams.tree_to_torch(np_codec, "cpu", torch.float32))
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(greedy=True,
                                                      max_tokens=max_tokens)
    return jm, tm


def test_port_worker_matches_jax_worker_fused_pipelined():
    jm, tm = _qwen3_pair(max_tokens=34)
    kw = dict(max_batch_size=2, num_pages=1200, page_size=8,
              max_prefill_requests=2, fused_decode_steps=4,
              fused_decode_buckets=(2,), pipeline_depth=2)
    jw = JWorker(jm, JWorkerConfig(prefill_token_buckets=(128,),
                                   warmup=False, **kw))
    tw = ModelWorker(tm, WorkerConfig(prefill_token_buckets=(128,), **kw))
    prompts = ("hi", "hello!")
    jreqs = [JRequest(request_id=f"j{i}", prompt=p)
             for i, p in enumerate(prompts)]
    treqs = [Request(request_id=f"t{i}", prompt=p)
             for i, p in enumerate(prompts)]
    _drive(JScheduler(model_worker=jw, max_batch_size=2, connect=False),
           jreqs)
    _drive(load_scheduler("base", model_worker=tw, max_batch_size=2,
                          connect=False), treqs)
    assert tw.step_stats()["replays"].get("decode_multi", 0) > 0
    for j, t in zip(jreqs, treqs):
        assert j.done_all and t.done_all
        assert len(t.lm_output_tokens) > 4
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))
        assert t.finish_reason == j.finish_reason
