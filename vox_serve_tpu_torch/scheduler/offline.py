"""Throughput-mode scheduler: LM while any LM work exists; detokenize only
when no LM work remains, packing the biggest chunk batch (reference
scheduler/offline.py).

A copy of vox_serve_tpu/scheduler/offline.py for the PyTorch port; only the
imports differ (the port's Request and base scheduler)."""

from __future__ import annotations

from ..requests import Request
from .base import Scheduler


class OfflineScheduler(Scheduler):
    # LM selection: the base policy (packed prefills first, else a decode
    # batch) is already offline-correct — only detokenize differs.

    def _select_detokenize_requests(self) -> list[Request]:
        if any(not r.done_lm_generation for r in self.active_requests):
            return []

        interval = self.model_worker.detokenize_interval
        step = interval - self.model_worker.detokenize_overlap
        selected: list[Request] = []
        total = 0
        for req in self.active_requests:
            if total >= self.max_batch_size:
                break
            next_idx = (req.next_audio_decode_idx[-1] + step
                        if req.next_audio_decode_idx else 0)
            idxs = []
            while (total < self.max_batch_size
                   and next_idx + interval <= len(req.lm_output_audio_tokens)):
                idxs.append(next_idx)
                next_idx += step
                total += 1
            if (req.done_lm_generation and total < self.max_batch_size
                    and next_idx < len(req.lm_output_audio_tokens)):
                idxs.append(next_idx)
                total += 1
            if idxs:
                req.next_audio_decode_idx = idxs
                selected.append(req)
            elif req.done_lm_generation:
                # boundary-exact finish: clear window indices so the final
                # chunk is not re-decoded/re-emitted (see base scheduler)
                req.next_audio_decode_idx = []
                req.done_all = True
                selected.append(req)
        return selected
