"""An overlap codec's stream ends on the window that reaches its last audio
token, whatever the order in which the end of generation and that
window's tokens arrive (the port's worker, ``_live_windows``).

A window of an overlap codec (interval W, overlap O) emits the audio of
its first W - O tokens, and the window that reaches the last token is the
stream's final one: the worker's ``_maybe_finish`` ends the stream there,
and ``chip_smoke.py``'s overlap rule counts the PCM so. When generation
ended in the round that completed that window, the schedulers (copies of
the JAX package's) also named one more final window at the next step,
holding only the lookahead tokens of the window before, and the worker
decoded it: 2.5 tokens' more audio than when the window had been selected
a round earlier (seen on the H100 as 74,400 samples instead of 72,000 for
a 78-token Step-Audio-2 stream). Here a small Chatterbox (W = 25, O = 3)
stream of n tokens ends before any of its windows is selected, or after
all its full windows are decoded; the base, online and offline schedulers
select its windows round after round and the worker decodes them: the
stream's PCM is the overlap rule's at every n, at the n where a window
reaches the last token (25, 47, 69, 91) and at those that end on a
partial window.
"""

import numpy as np
import pytest
import torch

from chip_smoke import overlap_pcm_samples
from test_torch_chatterbox import _tm
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worker():
    tm = _tm("ResembleAI/chatterbox")
    tm.sampling_config = tm.sampling_config.replace(max_tokens=200)
    return ModelWorker(tm, WorkerConfig(
        max_batch_size=4, num_pages=64, page_size=16,
        prefill_token_buckets=(128,), max_prefill_requests=2))


def _rounds(w, sched, req, rounds=20):
    """Detokenize rounds (the scheduler's selection, the worker's decode)
    until the stream is done or no window is selected."""
    for _ in range(rounds):
        sel = sched._select_detokenize_requests()
        if not sel:
            return
        w.run_detokenize(sel)
        w.flush_detokenize()
        if req.done_all:
            return


@pytest.mark.parametrize("sched_type", ["base", "online", "offline"])
@pytest.mark.parametrize("n", [25, 26, 47, 69, 70, 91, 95])
@pytest.mark.parametrize("done_first", [True, False])
def test_the_window_that_reaches_the_last_token_ends_the_stream(
        worker, sched_type, n, done_first):
    """``done_first``: generation ends before any window is selected;
    else every full window is decoded first and generation ends after."""
    w = worker
    sched = load_scheduler(sched_type, model_worker=w, max_batch_size=4,
                           connect=False)
    req = Request(request_id=f"{sched_type}{n}{done_first}", prompt="x",
                  is_streaming=True, is_pressing=True)
    w.run_lm_prefill([req])
    w.sync()
    try:
        req.lm_output_audio_tokens = [np.array([7 + i % 50], np.int32)
                                      for i in range(n)]
        sched.active_requests = [req]
        if not done_first:
            _rounds(w, sched, req)
        req.done_lm_generation = True
        _rounds(w, sched, req)
        assert req.done_all
        pcm = b""
        while not req.output_audio.empty():
            pcm += req.output_audio.get()
        interval, overlap = w.detokenize_interval, w.detokenize_overlap
        assert len(pcm) // 2 == overlap_pcm_samples(
            n, interval, overlap, w.model.output_audio_length), \
            req.extras["detok_windows"]
    finally:
        w.free_kv_cache(req)
