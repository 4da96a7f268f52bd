"""Greedy streams of a small port model through its worker and online
scheduler on the CPU, optionally with one of the daemon wrapper's faults
planted underneath: the rows, windows and PCM a run would judge."""

import numpy as np
import torch


def serve_small(model, texts, max_tokens: int, fault: str | None = None,
                kwargs: dict | None = None) -> list[dict]:
    from portbench import daemon
    from vox_serve_tpu_torch.models.base import BaseLM
    from vox_serve_tpu_torch.requests import Request
    from vox_serve_tpu_torch.scheduler import load_scheduler
    from vox_serve_tpu_torch.scheduler.base import Scheduler
    from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

    torch.set_num_threads(2)
    saved = (BaseLM.update_request_state, Scheduler._send)
    try:
        if fault:
            daemon.install_fault(fault)
        model.sampling_config = model.sampling_config.replace(
            greedy=True, max_tokens=max_tokens)
        worker = ModelWorker(model, WorkerConfig(
            max_batch_size=4, num_pages=1200, page_size=8,
            prefill_token_buckets=(64,), max_prefill_requests=4))
        s = load_scheduler("online", model_worker=worker, max_batch_size=4,
                           connect=False)
        reqs = [Request(request_id=f"r{i}", prompt=t, is_streaming=True,
                        model_kwargs=dict(kwargs or {}))
                for i, t in enumerate(texts)]
        for r in reqs:
            s.enqueue_request(r)
        for _ in range(600):
            s._step()
            if all(r.done_all for r in reqs):
                break
    finally:
        BaseLM.update_request_state, Scheduler._send = saved
    msgs = s._inproc_results
    items = []
    for r in reqs:
        pcm = b"".join(m.split(b"|", 2)[2] for m in msgs
                       if m.startswith(r.request_id.encode() + b"|AUDIO|"))
        items.append({"prompt": r.prompt,
                      "tokens": [[int(x) for x in row]
                                 for row in r.lm_output_tokens],
                      "windows": [list(w) for w in
                                  r.extras.get("detok_windows", [])],
                      "audio_tokens": len(r.lm_output_audio_tokens),
                      "pcm": np.frombuffer(pcm, np.int16)})
    return items
