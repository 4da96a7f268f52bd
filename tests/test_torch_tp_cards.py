"""The tensor-parallel worker on four cards (``cuda`` marker; skips where
fewer than four CUDA cards exist): the dummy model at ``tp_size=4`` (KH 2
over 4 ranks: one KV head a rank) gives the greedy tokens of ``tp_size=1``
on the same card, every step of every rank is a graph replay (no eager
call), each rank launched K1 and K3 in its graphs, and ``close`` ends the
ranks. Run on a four-card machine: ``python -m pytest
tests/test_torch_tp_cards.py -q``."""

import pytest
import torch

from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.sampling import SamplingConfig
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig


@pytest.mark.cuda
def test_tp4_worker_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")

    def run(tp):
        model = DummyLM(max_tokens=40, device="cuda:0", seed=0,
                        dtype=torch.bfloat16)
        model.sampling_config = SamplingConfig(greedy=True, max_tokens=40)
        w = ModelWorker(model, WorkerConfig(
            max_batch_size=2, num_pages=32, page_size=8,
            prefill_token_buckets=(32,), max_prefill_requests=2,
            tp_size=tp))
        w.reset_step_stats()
        req = Request(request_id="tp", prompt="hello four cards")
        w.run_lm_prefill([req])
        for _ in range(8):
            if req.done_lm_generation:
                break
            w.run_lm_decode([req])
        w.sync()
        tokens = [int(t[0]) for t in req.lm_output_tokens]
        stats = w.tp_stats()
        w.close()
        return tokens, stats

    ref, _ = run(1)
    got, stats = run(4)
    assert got == ref
    assert len(stats) == 4
    for r in stats:
        assert not any(r["eager_calls"].values()), r
        assert r["replays"]["prefill"] == 1
        assert r["kv_pool_shape"][3] == 2
        assert r["launches"]["paged_decode_attention"] > 0
        assert r["launches"]["ragged_prefill_attention"] > 0
