"""Per-request state machine (host side).

A copy of vox_serve_tpu/requests.py that imports the port's
``SamplingConfig`` (the JAX module imports ``sampling.py``, which imports
jax). Token history lives in host numpy, and each active request is pinned
to a *batch slot* — the index into the persistent device-side state
(repetition cache, feedback, last tokens, codec caches).
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Optional

import numpy as np

from .sampling import SamplingConfig


@dataclasses.dataclass(eq=False)
class Request:
    # eq=False: identity semantics. Field equality would make `req in list`
    # compare numpy-array fields (ValueError) whenever two distinct requests
    # share a request_id (client retry while the original is active) — and a
    # scheduler-side membership check must never treat two live requests as
    # interchangeable anyway.
    request_id: str
    prompt: Optional[str] = None
    audio_path: Optional[str] = None
    sampling_config: Optional[SamplingConfig] = None
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    # batch slot pinned for the lifetime of the request (device-state index)
    slot: Optional[int] = None

    # KV paging
    kv_pages: list[int] = dataclasses.field(default_factory=list)
    kv_token_len: int = 0

    # prompt tokens, shape (seq, n_codebooks) int32
    input_tokens: Optional[np.ndarray] = None
    input_length: int = 0
    # optional dense inputs prepared by preprocess
    input_features: Optional[np.ndarray] = None
    input_masks: Optional[np.ndarray] = None

    # raw LM outputs fed back into the LM, each (n_codebooks,) int32
    lm_output_tokens: list[np.ndarray] = dataclasses.field(default_factory=list)
    # audio tokens after filtering / delay-pattern revert, each (n_codebooks,)
    lm_output_audio_tokens: list[np.ndarray] = dataclasses.field(default_factory=list)
    # PCM chunks ready to send (bytes)
    output_audio: "queue.Queue[bytes]" = dataclasses.field(default_factory=queue.Queue)

    # progress
    done_lm_prefill: bool = False
    done_lm_generation: bool = False
    done_all: bool = False
    finish_reason: Optional[str] = None
    # audio-token indices already detokenized / scheduled next
    audio_decode_idx: list[int] = dataclasses.field(default_factory=list)
    next_audio_decode_idx: list[int] = dataclasses.field(default_factory=list)

    # scheduling
    is_pressing: bool = False
    is_streaming: bool = False
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)

    # input streaming (incremental text)
    is_input_streaming: bool = False
    input_text_buffer: str = ""
    pending_text_tokens: "queue.Queue[int]" = dataclasses.field(default_factory=queue.Queue)
    total_text_tokens: int = 0
    text_complete: bool = False
    waiting_for_text: bool = False
    prefill_ready: bool = False
    eos_injected: bool = False

    # chunk timing for pressing computation
    chunk_send_timestamps: list[float] = dataclasses.field(default_factory=list)
    chunk_durations: list[float] = dataclasses.field(default_factory=list)

    # lifecycle stamps (time.monotonic): "recv" at scheduler intake,
    # "prefill_dispatch" when the prefill/cold chain is dispatched,
    # "first_audio" at the first AUDIO send. Deltas go out in the
    # COMPLETION message ("timing") so the HTTP goodput client can
    # separate server TTFA from the ZMQ/HTTP hop (VERDICT r4 #1).
    lifecycle: dict = dataclasses.field(default_factory=dict)

    # model-specific host-side scratch (e.g. depth hidden handles)
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def next_position_id(self) -> int:
        return self.input_length + len(self.lm_output_tokens)

    @property
    def num_generated(self) -> int:
        return len(self.lm_output_tokens)

    def __repr__(self) -> str:  # keep logs short
        return (
            f"Request({self.request_id!r}, slot={self.slot}, "
            f"gen={self.num_generated}, done={self.done_all})"
        )
