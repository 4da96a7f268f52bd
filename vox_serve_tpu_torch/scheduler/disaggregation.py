"""LM / detokenizer disaggregation across two cards (port of
vox_serve_tpu/scheduler/disaggregation.py).

The worker is built with its detokenizer on another card
(``WorkerConfig.detokenizer_device_index``): the codec, its slot caches and
its graphs live there, and the LM's prefill and decode graphs on the LM's
card. Two asyncio loops, joined by an ``asyncio.Queue``, run the blocking
worker calls in two executor threads, so LM decode and detokenization
overlap in wall-clock; the worker's dispatch lock serializes their host
bookkeeping.

A copy of the JAX module with the port's imports and one addition: each
executor thread makes its card the current CUDA device once, when it
starts (torch's current device is per thread).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor

from ..requests import Request
from .base import Scheduler


def _current_device(device) -> None:
    """Executor-thread initializer: make ``device`` this thread's current
    CUDA device (nothing for another kind of device)."""
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.set_device(device)


class DisaggregationScheduler(Scheduler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.model_worker.detokenizer_device is None or (
            self.model_worker.detokenizer_device == self.model_worker.lm_device
        ):
            raise ValueError(
                "disaggregation requires a worker with a distinct "
                "detokenizer_device (>= 2 devices)"
            )
        self._detok_queue: asyncio.Queue = None
        self._lock: asyncio.Lock = None
        self._detokenizing_ids: set[str] = set()
        self._lm_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lm",
            initializer=_current_device,
            initargs=(self.model_worker.lm_device,))
        self._detok_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="detok",
            initializer=_current_device,
            initargs=(self.model_worker.detokenizer_device,))

    def run_forever(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        import json as _json

        self._detok_queue = asyncio.Queue()
        self._lock = asyncio.Lock()
        # READY handshake (base run_forever does this; without it the API
        # server's /health reports "warming" forever)
        model = getattr(self.model_worker, "model", None)
        self._send(b"__scheduler__|READY|" + _json.dumps({
            "rank": self.rank,
            "assets_available": bool(getattr(model, "assets_available",
                                             True)),
        }).encode())
        self.logger.info("disaggregation loops starting")
        await asyncio.gather(self._lm_loop(), self._detokenizer_loop())

    # ------------------------------------------------------------------
    async def _lm_loop(self) -> None:
        import os
        import time as _time

        loop = asyncio.get_running_loop()
        last_orphan_check = _time.monotonic()
        while True:
            now = _time.monotonic()
            if now - last_orphan_check > 5.0:
                last_orphan_check = now
                if os.getppid() == 1:
                    self.logger.info("parent process gone; scheduler exiting")
                    return
            async with self._lock:
                self._prepare_requests()
                lm = self._select_lm_requests()
                detok = self._queue_detokenize_requests()
            for req in detok:
                await self._detok_queue.put(req)
            if lm:
                # per-batch isolation as in base._step: one failing request
                # must not kill the rank
                try:
                    if not lm[0].done_lm_prefill:
                        await loop.run_in_executor(
                            self._lm_pool,
                            self.model_worker.run_lm_prefill, lm)
                        dec = self._select_decode_after_prefill(lm)
                        if dec:
                            await loop.run_in_executor(
                                self._lm_pool, self._run_decode, dec)
                    else:
                        # _run_decode routes through fused multi-step decode
                        # when eligible
                        await loop.run_in_executor(
                            self._lm_pool, self._run_decode, lm)
                except Exception as e:
                    async with self._lock:
                        self._fail_requests(lm, e, "lm step")
            else:
                await asyncio.sleep(0.0005)

    def _queue_detokenize_requests(self) -> list[Request]:
        """Select ready chunk windows, excluding requests already in flight
        on the detokenizer (the reference's detokenizing_request_ids)."""
        saved = self.active_requests
        self.active_requests = [
            r for r in saved if r.request_id not in self._detokenizing_ids
        ]
        try:
            detok = self._select_detokenize_requests()
        finally:
            self.active_requests = saved
        for r in detok:
            self._detokenizing_ids.add(r.request_id)
        return detok

    # ------------------------------------------------------------------
    async def _detokenizer_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            req = await self._detok_queue.get()
            batch = [req]
            while not self._detok_queue.empty() and len(batch) < self.max_batch_size:
                batch.append(self._detok_queue.get_nowait())
            try:
                emitted = await loop.run_in_executor(
                    self._detok_pool, self.model_worker.run_detokenize, batch)
                if self._detok_queue.empty():
                    # drain the readback pipeline only when no further batch
                    # is waiting: flushing every batch would hold the
                    # dispatch lock for the whole codec readback and
                    # serialize the two loops
                    emitted = emitted + await loop.run_in_executor(
                        self._detok_pool, self.model_worker.flush_detokenize)
                async with self._lock:
                    self._send_responses(emitted)
            except Exception as e:
                # fail the batch as base._step does: its windows' cursors
                # have already advanced, so skipping them would leave a gap
                # in the PCM stream
                async with self._lock:
                    self._fail_requests(batch, e, "detokenize")
            finally:
                for r in batch:
                    self._detokenizing_ids.discard(r.request_id)
