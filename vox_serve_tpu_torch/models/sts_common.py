"""Shared logic of the interleaved text/audio speech-to-speech models (port
of vox_serve_tpu/models/sts_common.py): the LM emits one mixed stream in
which audio tokens sit at ids >= ``audio_offset``; only audio tokens that
are not stop ids reach the detokenizer (GLM-4-Voice; Step-Audio-2 is the
next family to use it)."""

from __future__ import annotations

import numpy as np

from ..requests import Request


class InterleavedAudioMixin:
    """Requires: ``self.audio_offset``, ``self.stop_token_ids`` and the
    base class's ``hit_length_cap``."""

    audio_offset: int
    stop_token_ids: tuple[int, ...]

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) in self.stop_token_ids

    def update_request_state(self, req: Request, sampled: np.ndarray) -> None:
        req.lm_output_tokens.append(sampled)
        tok = int(sampled[0])
        stop = tok in self.stop_token_ids
        if tok >= self.audio_offset and not stop:
            req.lm_output_audio_tokens.append(sampled)
        if stop:
            req.done_lm_generation = True
            req.finish_reason = "stop"
        elif self.hit_length_cap(req):
            req.done_lm_generation = True
            req.finish_reason = "length"
