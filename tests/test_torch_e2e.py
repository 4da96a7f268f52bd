"""Port end to end on the CPU: the port's scheduler (in-process, no ZMQ)
driving its synchronous worker for ``dummy`` and for a debug-size Qwen3-TTS,
and one HTTP round trip through ``python -m vox_serve_tpu_torch.launch
--model dummy --device cpu`` (aiohttp -> ZMQ -> the port's scheduler
daemon -> worker -> streamed WAV)."""

import io
import json
import os
import socket
import subprocess
import sys
import time
import wave

import httpx
import numpy as np
import pytest
import torch

from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import Scheduler, load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drive(sched, reqs, max_steps=200):
    for r in reqs:
        sched.enqueue_request(r)
    for _ in range(max_steps):
        sched._step()
        if all(r.done_all for r in reqs):
            break
    return sched._inproc_results


def audio_of(msgs, rid):
    parts = [m.split(b"|", 2) for m in msgs if m.startswith(rid.encode()
                                                            + b"|")]
    pcm = b"".join(p[2] for p in parts if p[1] == b"AUDIO")
    comps = [json.loads(p[2]) for p in parts if p[1] == b"COMPLETION"]
    return np.frombuffer(pcm, np.int16), comps


@pytest.fixture(scope="module")
def dummy_worker():
    model = DummyLM(max_tokens=12, device="cpu")
    cfg = WorkerConfig(max_batch_size=4, num_pages=64, page_size=8,
                       prefill_token_buckets=(64,), max_prefill_requests=4)
    return ModelWorker(model, cfg)


def test_dummy_single_request_end_to_end(dummy_worker):
    s = Scheduler(model_worker=dummy_worker, max_batch_size=4, connect=False)
    req = Request(request_id="e2e1", prompt="hello port")
    x, comps = audio_of(drive(s, [req]), "e2e1")
    assert req.done_all
    assert x.size > 0 and np.abs(x).max() > 500  # a real signal
    assert len(comps) == 1 and comps[0]["status"] == "completed"


@pytest.mark.parametrize("sched_type", ["base", "online"])
def test_dummy_concurrent_requests_release_resources(dummy_worker,
                                                     sched_type):
    s = load_scheduler(sched_type, model_worker=dummy_worker,
                       max_batch_size=4, connect=False)
    reqs = [Request(request_id=f"c{i}", prompt=f"prompt number {i}",
                    is_streaming=True) for i in range(3)]
    drive(s, reqs)
    for r in reqs:
        assert r.done_all, r
        assert r.slot is None and not r.kv_pages
    assert dummy_worker.allocator.num_free == 63
    assert sorted(dummy_worker._free_slots) == [0, 1, 2, 3]


def _debug_qwen3():
    return Qwen3TTSLM(
        dtype=torch.float32, device="cpu", detokenize_interval=4,
        debug_backbone=BackboneConfig(
            vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            qk_norm=True, rope_theta=1e6, dtype=torch.float32),
        debug_depth=DepthConfig(
            hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True,
            dtype=torch.float32),
        debug_codec=Qwen3CodecConfig(
            codebook_dim=32, codebook_size=2048, latent_dim=48,
            decoder_dim=64, hidden_size=32, intermediate_size=64,
            head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
            num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
            upsampling_ratios=(2, 2), vq_dim=16))


def _drive_qwen3(model, worker):
    """Two streams through the online scheduler: each completes with the
    audio length its frame count implies."""
    s = load_scheduler("online", model_worker=worker, max_batch_size=4,
                       connect=False)
    reqs = [Request(request_id=f"q{i}", prompt=p, is_streaming=True)
            for i, p in enumerate(["hi", "hello!"])]
    msgs = drive(s, reqs)
    spf = model.codec_config.samples_per_frame
    for r in reqs:
        assert r.done_all and r.finish_reason in ("length", "stop")
        x, comps = audio_of(msgs, r.request_id)
        frames = len(r.lm_output_audio_tokens)
        assert frames > 0 and len(comps) == 1
        # full windows emit interval*spf samples; a final partial window of
        # n frames is trimmed to int(interval*spf * (n - 0.5) / interval)
        full, part = divmod(frames, 4)
        expect = full * 4 * spf + (int(4 * spf * (part - 0.5) / 4)
                                   if part else 0)
        assert x.size == expect
        assert all(t.shape == (17,) for t in r.lm_output_tokens)
    assert worker.allocator.num_free == 1199


def test_qwen3_debug_size_streams_through_scheduler():
    """Debug-size Qwen3-TTS (dual-channel prompt, depth loop, feedback,
    streaming codec in per-slot caches): two streams complete with the
    audio length their frame counts imply."""
    model = _debug_qwen3()
    model.sampling_config = model.sampling_config.replace(max_tokens=36)
    worker = ModelWorker(model, WorkerConfig(
        max_batch_size=4, num_pages=1200, page_size=8,
        prefill_token_buckets=(128,), max_prefill_requests=4))
    _drive_qwen3(model, worker)


def test_qwen3_int8_kv_and_fused_resunit_stream_to_pcm(monkeypatch):
    """The same two streams with an int8 KV pool and the codec's fused
    residual-unit path (VOX_FUSED_RESUNIT=1, K1q's and K2's configuration):
    the pool is int8 and every detokenize chunk took the fused stacks."""
    from vox_serve_tpu_torch.codecs import qwen3_codec

    monkeypatch.setenv("VOX_FUSED_RESUNIT", "1")
    calls = []
    real = qwen3_codec.fused_resunit_stack

    def spy(x, *args):
        calls.append(x.shape[-1])
        return real(x, *args)

    monkeypatch.setattr(qwen3_codec, "fused_resunit_stack", spy)
    model = _debug_qwen3()
    model.sampling_config = model.sampling_config.replace(max_tokens=36)
    worker = ModelWorker(model, WorkerConfig(
        max_batch_size=4, num_pages=1200, page_size=8,
        prefill_token_buckets=(128,), max_prefill_requests=4,
        kv_quant="int8"))
    assert worker.k_pages.dtype == torch.int8 and worker.v_pages is None
    assert model.kv_quant_scales == (16.0 / 127.0, 16.0 / 127.0)
    _drive_qwen3(model, worker)
    assert calls and min(calls) > 54


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_http_round_trip_through_launch():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--max-batch-size", "4",
         "--max-num-pages", "64", "--page-size", "8",
         "--prefill-buckets", "64", "--socket-suffix", f"_torch{port}"],
        cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "server died during startup"
            try:
                if httpx.get(base + "/health", timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.time() < deadline, "server did not become healthy"
            time.sleep(0.3)
        with httpx.stream("POST", base + "/generate",
                          data={"text": "hello from the port"},
                          timeout=120) as r:
            assert r.status_code == 200
            assert r.headers["content-type"].startswith("audio/wav")
            body = b"".join(r.iter_bytes())
        assert body[:4] == b"RIFF"
        assert len(body) > 44 and (len(body) - 44) % 2 == 0
        r = httpx.post(base + "/generate",
                       data={"text": "whole file", "streaming": "false"},
                       timeout=120)
        assert r.status_code == 200
        with wave.open(io.BytesIO(r.content), "rb") as wav:
            assert wav.getframerate() == DummyLM.SAMPLE_RATE
            assert wav.getsampwidth() == 2
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
