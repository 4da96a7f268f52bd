"""Port parity, the tensor-parallel worker (``WorkerConfig.tp_size``,
vox_serve_tpu_torch/parallel/ranks.py) on the CPU: rank 0 in this process,
ranks 1..tp-1 spawned processes joined by a ``gloo`` group (one thread
each).

* the port's ``ModelWorker`` at ``tp_size=4`` with the GLM debug config
  of ``tests/test_tensor_parallel.py`` and the JAX model's weights gives
  the greedy tokens of that test's ``_greedy_tokens(1)`` and
  ``_greedy_tokens(4)``; each rank's pool holds its KV heads only (the
  combined axis split 4 ways, bytes the whole pool's / 4), every rank ran
  every LM step;
* with fewer KV heads than ranks (the dummy model, KH 2 at tp 4) each
  rank's pool holds one KV head and the tokens are those of tp 1;
* a ``--tp-size 2 --device cpu`` launch answers 2 requests over HTTP, its
  stats file reports both ranks, and no rank process outlives it;
* ``cards_missing`` counts ``dp_size x tp_size`` cards; DP replica r is
  pinned to cards r*tp .. r*tp+tp-1; an unsupported tp raises naming H,
  KH and tp before any process starts; a rank that fails at start-up
  fails the worker and leaves no process; ``close`` ends the ranks.
"""

import dataclasses
import json
import multiprocessing
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import httpx
import jax
import numpy as np
import pytest
import torch

from test_tensor_parallel import FLOW, HIFT, SMALL, _greedy_tokens
from vox_serve_tpu.models.glm_voice import GLMVoiceLM as JGLM
from vox_serve_tpu_torch import launch
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs.glm_flow import GLMFlowConfig
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.models.glm_voice import GLMVoiceLM
from vox_serve_tpu_torch.parallel.ranks import TPStartupError
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.server import api
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _gone(pids, timeout=10.0) -> bool:
    """Whether every pid has exited (a zombie counts as gone) within
    ``timeout`` seconds."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        alive = []
        for pid in pids:
            try:
                with open(f"/proc/{pid}/status") as f:
                    if "\nState:\tZ" not in f.read():
                        alive.append(pid)
            except FileNotFoundError:
                pass
        if not alive:
            return True
        time.sleep(0.1)
    return False


def _port_glm(jm) -> GLMVoiceLM:
    """The port's GLM at the JAX test's debug config with the JAX model's
    weights."""
    bb = BackboneConfig(**{f.name: getattr(SMALL, f.name)
                           for f in dataclasses.fields(BackboneConfig)
                           if f.name != "dtype"}, dtype=torch.float32)
    tm = GLMVoiceLM(dtype=torch.float32, debug_backbone=bb,
                    debug_flow=GLMFlowConfig(**dataclasses.asdict(FLOW)),
                    debug_hift=HiFTConfig(**dataclasses.asdict(HIFT)))

    def to_torch(tree):
        return tparams.tree_to_torch(jax.tree.map(np.asarray, tree), "cpu",
                                     torch.float32)

    tm.params = to_torch(jm.params)
    tm.codec_params = to_torch(jm.codec_params)
    tm.sampling_config = SamplingConfig(greedy=True, max_tokens=512)
    return tm


def _greedy(worker, steps=6):
    req = Request(request_id="tp", prompt="hello")
    worker.run_lm_prefill([req])
    for _ in range(steps):
        if req.done_lm_generation:
            break
        worker.run_lm_decode([req])
    worker.sync()
    worker.free_kv_cache(req)
    return [int(t[0]) for t in req.lm_output_tokens]


def test_tp4_worker_matches_jax_greedy_and_splits_the_pool():
    jm = JGLM(dtype=SMALL.dtype, debug_backbone=SMALL, debug_flow=FLOW,
              debug_hift=HIFT)
    tm = _port_glm(jm)
    wcfg = dict(max_batch_size=2, num_pages=128, page_size=16,
                prefill_token_buckets=(512,), max_prefill_requests=2,
                warmup=False)
    worker = ModelWorker(tm, WorkerConfig(**wcfg, tp_size=4))
    try:
        got = _greedy(worker)
        stats = worker.tp_stats()
        pids = [r["pid"] for r in stats]
    finally:
        worker.close()
    assert _gone(pids[1:])
    t1, t4 = _greedy_tokens(1), _greedy_tokens(4)
    assert len(got) >= 3
    assert got == t1 == t4
    # the combined (L, P, page, 2KH, D) pool's head axis, split 4 ways
    whole = 2 * 128 * 16 * 2 * SMALL.num_kv_heads * 16 * 4
    assert [r["rank"] for r in stats] == [0, 1, 2, 3]
    for r in stats:
        assert r["kv_pool_shape"] == [2, 128, 16,
                                      2 * SMALL.num_kv_heads // 4, 16]
        assert r["kv_pool_bytes"] == whole // 4
        assert r["replays"] == {"prefill": 1, "decode": len(got) - 1}
        assert r["graphs"] == stats[0]["graphs"]


def test_one_kv_head_a_rank_when_tp_exceeds_kv_heads():
    def run(tp):
        model = DummyLM(max_tokens=40, seed=0)
        model.sampling_config = SamplingConfig(greedy=True, max_tokens=40)
        w = ModelWorker(model, WorkerConfig(
            max_batch_size=2, num_pages=32, page_size=8,
            prefill_token_buckets=(32,), max_prefill_requests=2,
            warmup=False, tp_size=tp))
        try:
            return _greedy(w, steps=8), w.tp_stats()
        finally:
            w.close()

    ref, _ = run(1)
    got, stats = run(4)
    assert got == ref
    for r in stats:  # KH 2 over 4 ranks: one KV head (K and V rows) each
        assert r["kv_pool_shape"][3] == 2
        assert r["kv_pool_bytes"] == 2 * 32 * 8 * 2 * 16 * 4


def test_unsupported_tp_raises_before_any_process_starts():
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(ValueError) as e:
        ModelWorker(DummyLM(seed=0), WorkerConfig(
            max_batch_size=2, num_pages=16, prefill_token_buckets=(32,),
            warmup=False, tp_size=3))
    assert "H=4" in str(e.value) and "KH=2" in str(e.value)
    assert "tp=3" in str(e.value)
    after = {p.pid for p in multiprocessing.active_children()}
    assert after <= before


def test_failed_rank_fails_the_worker_and_leaves_no_process():
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(TPStartupError) as e:
        # rank 1 on a card this machine does not have
        ModelWorker(DummyLM(seed=0), WorkerConfig(
            max_batch_size=2, num_pages=16, prefill_token_buckets=(32,),
            warmup=False, tp_size=2, devices=("cpu", "cuda:1")))
    assert "rank 1" in str(e.value)
    left = [p for p in multiprocessing.active_children()
            if p.pid not in before]
    assert not left
    assert not torch.distributed.is_initialized()


def test_cards_missing_counts_dp_times_tp():
    p = launch.build_parser()
    a = p.parse_args(["--tp-size", "4"])
    assert launch.cards_missing(a, 4) is None
    msg = launch.cards_missing(a, 1)
    assert "--tp-size 4 needs 4 CUDA cards" in msg and "has 1" in msg
    a = p.parse_args(["--dp-size", "2", "--tp-size", "2"])
    assert launch.cards_missing(a, 4) is None
    assert "needs 4 CUDA cards; this machine has 3" in launch.cards_missing(
        a, 3)
    assert launch.cards_missing(p.parse_args(["--tp-size", "4", "--device",
                                              "cpu"]), 0) is None


def test_dp_replicas_pinned_to_their_tp_cards(monkeypatch):
    assert [api.replica_cards(r, 2) for r in range(2)] == ["0,1", "2,3"]
    assert api.replica_cards(1, 1) == "1"
    seen = []

    class FakePopen:
        def __init__(self, cmd, env):
            seen.append((cmd, env.get("CUDA_VISIBLE_DEVICES")))

    monkeypatch.setattr(api.subprocess, "Popen", FakePopen)
    fake = types.SimpleNamespace(
        dp_size=2, model_name="dummy", scheduler_type="online",
        max_batch_size=4, socket_suffix="_t", scheduler_processes=[],
        logger=api.get_logger("test"),
        scheduler_args={"tp_size": 2, "device": "cuda"})
    api.APIServer._start_schedulers(fake)
    assert [cards for _, cards in seen] == ["0,1", "2,3"]
    assert all(cmd[cmd.index("--tp-size") + 1] == "2" for cmd, _ in seen)


def test_tp_size_reaches_the_worker_config():
    from vox_serve_tpu_torch import scheduler_entry

    args = scheduler_entry.build_parser().parse_args(
        ["--model", "dummy", "--tp-size", "2"])
    assert scheduler_entry.worker_config(args).tp_size == 2
    flags = api.scheduler_flags({"tp_size": 2, "device": "cpu"})
    assert flags == ["--tp-size", "2", "--device", "cpu"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tp2_launch_serves_over_http(tmp_path):
    port = _free_port()
    stats = tmp_path / "stats.json"
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--tp-size", "2",
         "--port", str(port), "--host", "127.0.0.1",
         "--socket-suffix", f"_ttp{port}", "--stats-file", str(stats)],
        cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    results = []
    try:
        while True:
            assert proc.poll() is None, "server died during start-up"
            try:
                if httpx.get(base + "/health", timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.monotonic() - t0 < 60, "not healthy within 60 s"
            time.sleep(0.3)

        def go(i):
            r = httpx.post(base + "/generate",
                           data={"text": f"tp request {i}",
                                 "streaming": "false"}, timeout=60)
            results.append((r.status_code, len(r.content)))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    assert len(results) == 2
    assert all(status == 200 and size > 44 for status, size in results)
    for _ in range(100):
        if stats.exists() and stats.stat().st_size:
            break
        time.sleep(0.1)
    st = json.loads(stats.read_text())
    assert st["tp_size"] == 2 and st["tp_devices"] == ["cpu", "cpu"]
    assert len(st["requests"]) == 2
    ranks = st["tp_ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    lm = {k: n for k, n in ranks[0]["replays"].items() if k != "detok"}
    assert lm and ranks[1]["replays"] == lm
    assert ranks[1]["kv_pool_bytes"] == ranks[0]["kv_pool_bytes"]
    assert _gone([r["pid"] for r in ranks])
