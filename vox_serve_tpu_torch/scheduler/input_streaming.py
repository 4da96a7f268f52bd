"""Incremental streaming *text input* scheduler (reference
scheduler/input_streaming.py).

Protocol: ``rid|TEXT_STREAM_START|<cfg json>`` opens a session;
``rid|TEXT_UPDATE|<text>`` appends text; ``rid|TEXT_COMPLETE|`` closes it.
Text is buffered until MIN_INITIAL_TEXT_CHARS, then the request prefills with
exactly ONE text token; the rest (and all later updates) go into a pending
token queue that the worker injects one-per-decode-step
(worker/base.py ``_inject_streaming_text_token``). When the queue drains
before TEXT_COMPLETE, generation pauses (``waiting_for_text``); after
TEXT_COMPLETE the model's EOS is injected once, then pad.

A copy of vox_serve_tpu/scheduler/input_streaming.py for the PyTorch port;
only the imports differ (the port's Request and online scheduler).
"""

from __future__ import annotations

import json

from ..requests import Request
from .online import OnlineScheduler

MIN_INITIAL_TEXT_CHARS = 20


class InputStreamingScheduler(OnlineScheduler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not self.model_worker.model.supports_input_streaming:
            raise ValueError(
                f"model {self.model_worker.model.model_name} does not "
                "support input streaming"
            )
        self._streams: dict[str, Request] = {}

    # -- message dispatch -------------------------------------------------
    def _handle_message(self, payload: bytes) -> None:
        parts = payload.split(b"|", 2)
        # a JSON /generate frame starts with '{'; without this guard a
        # prompt containing "|TEXT_UPDATE|" would be misrouted as a
        # text-stream control frame and silently dropped
        if len(parts) == 3 and not parts[0].startswith(b"{") and parts[1] in (
            b"TEXT_STREAM_START", b"TEXT_UPDATE", b"TEXT_COMPLETE",
        ):
            rid = parts[0].decode()
            kind = parts[1]
            body = parts[2]
            if kind == b"TEXT_STREAM_START":
                self._handle_stream_start(rid, body)
            elif kind == b"TEXT_UPDATE":
                self._handle_text_update(rid, body.decode("utf-8"))
            else:
                self._handle_text_complete(rid)
            return
        super()._handle_message(payload)

    def _handle_stream_start(self, rid: str, body: bytes) -> None:
        try:
            cfg = json.loads(body.decode("utf-8")) if body else {}
        except Exception:
            cfg = {}
        req = Request(
            request_id=rid,
            prompt="",
            is_streaming=True,
            is_pressing=True,
            is_input_streaming=True,
            model_kwargs=cfg.get("model_kwargs", {}),
        )
        self._streams[rid] = req
        self.active_requests.append(req)
        self.logger.debug("text stream started: %s", rid)

    def _handle_text_update(self, rid: str, text: str) -> None:
        req = self._streams.get(rid)
        if req is None or req.done_all:
            self.logger.warning("TEXT_UPDATE for unknown stream %s", rid)
            return
        model = self.model_worker.model
        if not req.prefill_ready:
            req.input_text_buffer += text
            if len(req.input_text_buffer) >= MIN_INITIAL_TEXT_CHARS:
                self._prepare_prefill_with_minimal_text(req)
        else:
            for tok in model.tokenize_text_stream(text):
                req.pending_text_tokens.put(tok)
                req.total_text_tokens += 1

    def _handle_text_complete(self, rid: str) -> None:
        req = self._streams.get(rid)
        if req is None:
            return
        if not req.prefill_ready and req.input_text_buffer:
            # short utterance: prefill with whatever we have
            self._prepare_prefill_with_minimal_text(req)
        if not req.prefill_ready:
            # closed with no usable text (empty stream, or whitespace that
            # tokenizes to nothing): complete immediately — the request
            # would otherwise sit paused forever (client hangs to timeout,
            # Request leaks in active_requests)
            self.logger.info("stream %s closed with no text; completing",
                             rid)
            req.done_lm_generation = True
            req.done_all = True
            req.finish_reason = "empty_stream"
            self._send_completion(req)
            self.active_requests = [r for r in self.active_requests
                                    if r is not req]
            self._streams.pop(rid, None)
            return
        req.text_complete = True
        self.logger.debug("text stream complete: %s", rid)

    def _send_responses(self, emitted) -> None:
        super()._send_responses(emitted)
        # drop finished sessions from the stream map — entries previously
        # lived for the process lifetime (unbounded memory; stale rids
        # absorbed late TEXT_UPDATEs instead of warning)
        for rid in [rid for rid, r in self._streams.items() if r.done_all]:
            self._streams.pop(rid, None)

    def _prepare_prefill_with_minimal_text(self, req: Request) -> None:
        """Prefill with exactly one text token; queue the rest."""
        model = self.model_worker.model
        tokens = model.tokenize_text_stream(req.input_text_buffer)
        if not tokens:
            return
        po = model.preprocess(
            prompt=None, streaming_first_token=tokens[0], **req.model_kwargs
        )
        import numpy as np

        req.input_tokens = np.asarray(po.input_tokens, np.int32)
        req.input_length = len(req.input_tokens)
        req.input_features = po.input_features
        req.input_masks = po.input_masks
        for tok in tokens[1:]:
            req.pending_text_tokens.put(tok)
        req.total_text_tokens = len(tokens)
        req.input_text_buffer = ""
        req.prefill_ready = True

    # -- selection: skip paused / still-buffering requests ----------------
    def _select_lm_requests(self):
        paused = []
        for req in self.active_requests:
            if not req.is_input_streaming or req.done_lm_generation:
                continue
            if not req.done_lm_prefill and not req.prefill_ready:
                paused.append(req)  # still buffering initial text
            elif (req.done_lm_prefill and req.pending_text_tokens.empty()
                  and not req.text_complete):
                req.waiting_for_text = True
                paused.append(req)
        if not paused:
            return super()._select_lm_requests()
        saved = self.active_requests
        self.active_requests = [r for r in saved if r not in paused]
        try:
            return super()._select_lm_requests()
        finally:
            self.active_requests = saved
