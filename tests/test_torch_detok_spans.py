"""The detokenize counters and the flow model's device-timed parts:

* a served CPU run of a small CosyVoice2 through the worker and the online
  scheduler counts ``detok.rows`` (bucket rows a replay runs) beside
  ``detok.windows`` over the same replays, and records no ``detok.flow``
  or ``detok.hift`` (no events off the card);
* the reading at readback: each part's elapsed ms is added once per
  resolved replay, and a replay whose graph was replayed again before its
  readback is not read (its events then hold the later replay);
* on the card (marker ``cuda``), the flow and HiFT events captured in a
  detokenize graph time every replay: each part > 0 ms, both together at
  most the replay's wall time.

This file imports neither jax nor the JAX package; its card test alone:

    python -m pytest tests/test_torch_detok_spans.py -q -m cuda
"""

import time

import numpy as np
import pytest
import torch

from vox_serve_tpu_torch.codecs.cosyvoice_flow import CosyFlowConfig
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.cosyvoice2 import CosyVoice2LM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig
from vox_serve_tpu_torch.worker.base import _PendingDetok

BB = dict(vocab_size=151936, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qkv_bias=True,
          rope_theta=1_000_000.0)
FLOW = dict(input_size=32, output_size=32, heads=4, linear_units=64,
            num_blocks=1, up_blocks=1, vocab_size=6561, spk_dim=8,
            mel_dim=16, est_channels=16, est_head_dim=8, est_heads=2,
            est_n_blocks=1, est_mid_blocks=1, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=4,
            upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
            f0_cond_channels=16)


def small_cosy(device="cpu", seed=3, head_dim=16):
    bb = dict(BB, head_dim=head_dim)
    return CosyVoice2LM(
        dtype=torch.float32, device=device, seed=seed,
        debug_backbone=BackboneConfig(**bb, dtype=torch.float32),
        debug_flow=CosyFlowConfig(**FLOW), debug_hift=HiFTConfig(**HIFT))


@pytest.fixture(scope="module")
def served_worker():
    """Three greedy streams through the worker and the online scheduler
    at batch 4 (detokenize buckets 1, 2, 4)."""
    torch.set_num_threads(2)
    model = small_cosy()
    model.sampling_config = model.sampling_config.replace(
        greedy=True, max_tokens=90)
    worker = ModelWorker(model, WorkerConfig(
        max_batch_size=4, num_pages=600, page_size=8,
        prefill_token_buckets=(64,), max_prefill_requests=4))
    s = load_scheduler("online", model_worker=worker, max_batch_size=4,
                       connect=False)
    reqs = [Request(request_id=f"r{i}", prompt=t, is_streaming=True)
            for i, t in enumerate(["one short line", "and a second one",
                                   "a third"])]
    for r in reqs:
        s.enqueue_request(r)
    for _ in range(600):
        s._step()
        if all(r.done_all for r in reqs):
            break
    assert all(r.done_all for r in reqs)
    return worker


def test_served_run_counts_rows_beside_windows(served_worker):
    ph = served_worker.phase_stats
    windows, replays = ph["detok.windows"]
    rows, row_replays = ph["detok.rows"]
    assert replays == row_replays > 0
    assert rows >= windows > 0
    # every replay's rows are a bucket at or above its windows
    assert rows <= windows * max(served_worker.config.detok_buckets)
    assert "detok.flow" not in ph and "detok.hift" not in ph


class _FakeEvent:
    def __init__(self, t_ms: float):
        self.t_ms = t_ms

    def elapsed_time(self, end: "_FakeEvent") -> float:
        return end.t_ms - self.t_ms


def test_parts_are_read_once_per_resolved_replay(served_worker):
    w = served_worker
    key, other = ("detok", 1, 28), ("detok", 2, 28)
    w._detok_marks[key] = {"flow": (_FakeEvent(1.0), _FakeEvent(4.0)),
                           "hift": (_FakeEvent(4.0), _FakeEvent(4.5))}
    w._detok_marks[other] = {"flow": (_FakeEvent(0.0), _FakeEvent(8.0)),
                             "hift": (_FakeEvent(8.0), _FakeEvent(9.0))}
    try:
        w.phase_stats.clear()
        pcm = torch.zeros((1, 1, 0), dtype=torch.int16)
        # key twice in flight: the first is not read, the second is
        for k in (key, other, key):
            w._pending_detok.append(_PendingDetok(pcm, None, [], [], k))
        while w._pending_detok:
            w._resolve_detok()
        assert w.phase_stats["detok.flow"] == pytest.approx((0.011, 2))
        assert w.phase_stats["detok.hift"] == pytest.approx((0.0015, 2))
        assert w.detok_part_ms(("detok", 4, 28)) == {}
    finally:
        w._detok_marks.clear()
        w.phase_stats.clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flow_and_hift_events_time_each_replay(cuda_device):
    """The published flow and HiFT (a small LM): the events captured in
    two detokenize graphs, read after each replay."""
    model = CosyVoice2LM(
        dtype=torch.bfloat16, device=cuda_device, seed=7,
        debug_backbone=BackboneConfig(**dict(BB, head_dim=64),
                                      dtype=torch.bfloat16))
    worker = ModelWorker(model, WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=16, warmup=False,
        prefill_token_buckets=(64,), max_prefill_requests=2))
    try:
        for B, L in ((1, 28), (2, 53)):
            key = ("detok", B, L)
            pack = np.zeros((B * L + B,), np.int32)
            pack[:B * L] = np.arange(B * L) % 6561
            pack[B * L:] = worker.config.max_batch_size  # the sentinel slot
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                worker._steps.run(key, pack)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                ms = worker.detok_part_ms(key)
                assert set(ms) == {"flow", "hift"}
                assert ms["flow"] > 0 and ms["hift"] > 0, ms
                assert ms["flow"] + ms["hift"] <= wall_ms, (ms, wall_ms)
    finally:
        worker.close()
