"""Playback-deadline-aware ("pressing") scheduler.

Policy parity with reference scheduler/online.py: streaming requests are
*pressing* until their first chunk is sent, and again whenever client-side
playback has caught up to within 1 s of the last sent chunk. Critical decodes
are batched first with non-critical piggybacked; the detokenize batch is
proportionally allocated across pressing requests and may assign multiple
chunk windows to one request.

A copy of vox_serve_tpu/scheduler/online.py for the PyTorch port; only the
imports differ.
"""

from __future__ import annotations

import os
import time

from ..requests import Request
from .base import Scheduler

PRESSING_BUFFER_S = 1.0


class OnlineScheduler(Scheduler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.detokenize_max_batch_size = self.max_batch_size
        # cold-chain load gate (see _maybe_cold_start); None = auto
        # (max_batch_size // 2). VOX_COLD_START_MAX_DECODING overrides
        # for serving A/Bs without a relaunch-time profile edit.
        env = os.environ.get("VOX_COLD_START_MAX_DECODING")
        self._cold_start_max_decoding = int(env) if env else None
        # burst smoothing: with synchronized streams, window boundaries
        # align and a step's detok batch can spike far past the per-step
        # average (max_batch / interval), overflowing into a much wider
        # (and much slower) codec bucket. Cap per-step selection at the
        # detok bucket covering steady-state demand — pressing priority
        # and proportional allocation decide WHO fills it, and deferred
        # windows drain over the following (underfull) steps.
        # deadline-driven detok deferral (A/B knob, default OFF): defer
        # non-urgent windows until a stream is within margin_s of underrun,
        # then serve all ready windows in one amortized batch. Measured
        # NEGATIVE at margin 0.6 s over HTTP (rate-1 all-chunks viability
        # 95.1 -> 69.2, artifacts/goodput_tpu_r5_run4.json vs run6 in git
        # history): batching near the deadline leaves no slack for detok
        # device time + dispatch queueing + the ZMQ/HTTP hop, and the
        # fused-k granularity schedule (WorkerConfig.fused_k_schedule)
        # amortizes rounds without touching delivery slack. Kept as an
        # opt-in experiment: VOX_DETOK_GATE_MARGIN_S=<seconds>.
        self._detok_defer_rounds = 0
        self._detok_gate_margin_s = float(
            os.environ.get("VOX_DETOK_GATE_MARGIN_S", "0"))
        worker_cfg = getattr(self.model_worker, "config", None)
        interval = getattr(self.model_worker, "detokenize_interval", 0)
        overlap = getattr(self.model_worker, "detokenize_overlap", 0)
        if worker_cfg is not None and interval:
            step = max(interval - overlap, 1)
            # full-batch fused decode emits k frames per scheduler round, so
            # steady-state window demand scales by k (without this the cap
            # starves the codec and audio backlog grows without bound)
            k = 1
            if (worker_cfg.fused_decode_steps
                    and worker_cfg.fused_decode_buckets
                    and max(worker_cfg.fused_decode_buckets)
                    >= self.max_batch_size):
                k = worker_cfg.fused_decode_steps
            demand = -(-self.max_batch_size * k // step)  # ceil
            for b in worker_cfg.detok_buckets:
                if b >= demand:
                    self.detokenize_max_batch_size = min(
                        self.max_batch_size, b)
                    break

    # -- cold-start fast path --------------------------------------------
    def _maybe_cold_start(self, lm) -> bool:
        """Near-idle streaming prefill: chain prefill + fused decode +
        first-chunk detok (worker.run_cold_start) so first PCM costs ONE
        dispatch and one readback. Under load the normal batched path
        keeps the chip busy for everyone instead."""
        if len(lm) != 1 or not lm[0].is_streaming:
            return False
        req = lm[0]
        ccs = getattr(self.model_worker, "can_cold_start", None)
        if ccs is None or not ccs(req):
            return False
        decoding = max(
            sum(1 for r in self.active_requests
                if r.done_lm_prefill and not r.done_all and r is not req),
            getattr(self, "_load_pressure", 0) - 1)
        # load gate: a B=1 cold chain spends ~40 ms of device time that the
        # shared batch doesn't get. Up to ~half the serving batch the duty
        # cycle absorbs it and TTFA drops from ~3 dispatch rounds to one
        # chained dispatch; near saturation the packed-prefill path wins
        # (throughput) — measured HTTP A/B in artifacts/goodput_tpu_r5.json.
        limit = self._cold_start_max_decoding
        if limit is None:
            cfg = getattr(self.model_worker, "config", None)
            fmin = getattr(cfg, "fused_min_batch", None) if cfg else None
            if fmin:
                # latency regime only (hysteresis latch shared with the
                # fused-round and ramp decisions): past it, a B=1 chain
                # spends ~40-145 ms of device time per admission that the
                # shared batch doesn't get (~36% of the chip at 4 req/s),
                # and packed prefills amortize admissions instead
                if self._throughput_regime(decoding, fmin):
                    return False
                if getattr(cfg, "fused_k_schedule", None):
                    # with a granularity schedule the latency regime spans
                    # most of the batch range; past ~fmin/3 live streams
                    # the packed-prefill + scheduled-k path already gives
                    # ~0.3 s TTFA and a B=1 chain's ~40 ms device time per
                    # admission is pure tax on the shared batch
                    limit = max(2, fmin // 3)
                else:
                    limit = self.max_batch_size
            else:
                limit = max(2, self.max_batch_size // 2)
        if decoding > limit:
            return False
        self.model_worker.run_cold_start(req)
        return True

    # -- intake hooks ---------------------------------------------------
    def _prepare_requests(self) -> None:
        super()._prepare_requests()
        self._update_pressing_status()
        # load pressure for the regime latch: live decode PLUS the
        # admission backlog. Under saturation, streams complete in waves
        # (max_tokens-synchronized admissions), live decode briefly hits 0,
        # and the latch flipped to the latency regime exactly as the queued
        # backlog admitted — those streams took mini-ramp first chunks and
        # were then caught by the next throughput flip at fused-round
        # granularity, structurally missing early deadlines (measured as
        # the rate-6/10 per-chunk viability collapse, run7 in git history
        # vs artifacts/goodput_tpu_r5_run4.json). Backlog counts as load
        # because it will be decoding within a few admission rounds.
        # finished-but-unflushed streams are detok load, not decode
        # demand: counting them inflated pressure past the boundary at
        # light load (churned completions awaiting flush) and flapped the
        # latch at rates 1-2
        self._load_pressure = sum(
            1 for r in self.active_requests
            if not r.done_all and not r.done_lm_generation
            and (r.done_lm_prefill or not r.waiting_for_text))

    def _update_pressing_status(self) -> None:
        now = time.time()
        for req in self.active_requests:
            if not req.is_streaming:
                req.is_pressing = False
                continue
            if not req.chunk_send_timestamps:
                req.is_pressing = True
                continue
            first_send = req.chunk_send_timestamps[0]
            total_playback = sum(req.chunk_durations)
            latest_chunk_start = first_send + total_playback - req.chunk_durations[-1]
            req.is_pressing = now >= latest_chunk_start - PRESSING_BUFFER_S

    # -- LM selection: critical first ------------------------------------
    def _select_lm_requests(self) -> list[Request]:
        prefill, critical, background = [], [], []
        for req in self.active_requests:
            if req.done_lm_generation:
                continue
            if not req.done_lm_prefill:
                prefill.append(req)
            elif req.is_pressing:
                critical.append(req)
            else:
                background.append(req)

        sel = self._pack_prefills(prefill)
        if sel:
            return sel

        out = critical[: self.max_batch_size]
        for req in background:
            if len(out) >= self.max_batch_size:
                break
            out.append(req)
        return out

    # -- detokenize selection: proportional allocation --------------------
    def _select_detokenize_requests(self) -> list[Request]:
        interval = self.model_worker.detokenize_interval
        step = interval - self.model_worker.detokenize_overlap

        # TTFA first-chunk minis: a brand-new stream with >= first_chunk_frames
        # audio frames gets a short window immediately instead of waiting for
        # a full interval
        F = getattr(self.model_worker, "first_chunk_frames", 0)
        mini_sel: list[Request] = []
        if F:
            for req in self.active_requests:
                if not req.is_streaming or req.audio_decode_idx \
                        or req.next_audio_decode_idx:
                    continue
                ramp_next = req.extras.get("ramp_next", 0)
                ramp_end = getattr(self.model_worker, "ramp_frames",
                                   interval) or interval
                if ramp_next >= ramp_end:
                    continue
                if req.done_lm_generation:
                    # leave the ramp; the regular final-partial rule takes
                    # over from the frames already consumed
                    step_ = interval - self.model_worker.detokenize_overlap
                    req.audio_decode_idx = [ramp_next - step_]
                    req.next_audio_decode_idx = [ramp_next - step_]
                    continue
                size = req.extras.get("ramp_size", F)
                if (len(req.lm_output_audio_tokens) >= ramp_next + size
                        and len(mini_sel) < self.detokenize_max_batch_size):
                    req.extras["mini_chunk"] = True
                    mini_sel.append(req)

        candidates = []
        for req in self.active_requests:
            if req.extras.get("mini_chunk"):
                continue
            if (F and req.is_streaming and not req.done_lm_generation
                    and not req.audio_decode_idx
                    and req.extras.get("ramp_next", 0)
                    < (getattr(self.model_worker, "ramp_frames", interval)
                       or interval)):
                continue  # still ramping via mini chunks
            next_idx = (req.next_audio_decode_idx[-1] + step
                        if req.next_audio_decode_idx else 0)
            if req.done_lm_generation:
                if next_idx < len(req.lm_output_audio_tokens):
                    candidates.append(req)
                else:
                    # boundary-exact finish: clear window indices so the final
                    # chunk is not re-decoded/re-emitted (see base scheduler)
                    req.next_audio_decode_idx = []
                    req.done_all = True
                    candidates.append(req)
            elif next_idx + interval <= len(req.lm_output_audio_tokens):
                candidates.append(req)
        if not candidates:
            return mini_sel

        # latency-regime deadline-driven batching (see __init__): defer the
        # whole detok dispatch while no stream is near underrun. First
        # chunks (no send timestamp yet), finished streams (tail flush
        # frees KV/slots), and non-streaming requests (whole-utterance
        # latency) always dispatch. The defer-round cap is a safety net
        # against clock anomalies, not a tuning knob.
        if (not self._regime_fused and not mini_sel
                and self._detok_gate_margin_s > 0):
            now = time.time()
            urgent = False
            for r in candidates:
                if (r.done_lm_generation or not r.is_streaming
                        or not r.chunk_send_timestamps):
                    urgent = True
                    break
                underrun_at = (r.chunk_send_timestamps[0]
                               + sum(r.chunk_durations))
                if now >= underrun_at - self._detok_gate_margin_s:
                    urgent = True
                    break
            if not urgent and self._detok_defer_rounds < 200:
                self._detok_defer_rounds += 1
                return []
        self._detok_defer_rounds = 0

        critical = [r for r in candidates if r.is_pressing]
        background = [r for r in candidates if not r.is_pressing]
        # NOTE: no early return when critical is empty — background requests
        # (non-streaming /generate traffic) then get the whole budget below;
        # an early return here starved them forever on a stream-free server.

        # remaining-chunk counts per critical request
        def remaining_chunks(req: Request) -> int:
            if req.done_all:
                return 0
            next_idx = (req.next_audio_decode_idx[-1] + step
                        if req.next_audio_decode_idx else 0)
            remaining = len(req.lm_output_audio_tokens) - next_idx
            # a non-final window consumes `interval` tokens and advances by
            # `step`; `remaining // step` overcounted when overlap > 0,
            # leaking pressing quota to background under saturation
            count = max(0, (remaining - interval) // step + 1)
            if req.done_lm_generation and remaining - count * step > 0:
                count += 1  # final partial window
            return count

        counts = [remaining_chunks(r) for r in critical]
        total = sum(counts)
        cap = self.detokenize_max_batch_size
        if total <= cap:
            assigned = counts
        else:
            assigned = [max(1, (c * cap) // total) for c in counts]
            while sum(assigned) > cap:
                changed = False
                for i in range(len(assigned)):
                    if assigned[i] > 1:
                        assigned[i] -= 1
                        changed = True
                        if sum(assigned) <= cap:
                            break
                if not changed:
                    break

        selected: list[Request] = []
        used = 0

        def take_chunks(req: Request, budget: int) -> int:
            if req.done_all:  # nothing left to decode; just flush COMPLETION
                selected.append(req)
                return 0
            next_idx = (req.next_audio_decode_idx[-1] + step
                        if req.next_audio_decode_idx else 0)
            idxs = []
            while (budget > 0 and
                   next_idx + interval <= len(req.lm_output_audio_tokens)):
                idxs.append(next_idx)
                next_idx += step
                budget -= 1
            if (req.done_lm_generation and budget > 0
                    and next_idx < len(req.lm_output_audio_tokens)):
                idxs.append(next_idx)
                budget -= 1
            if not idxs:
                return 0
            req.next_audio_decode_idx = idxs
            selected.append(req)
            return len(idxs)

        stats = getattr(self.model_worker, "phase_stats", None)
        if stats is not None:
            t, c = stats.get("sched.detok_candidates", (0.0, 0))
            stats["sched.detok_candidates"] = (t + len(candidates), c + 1)

        for req, quota in zip(critical, assigned):
            if quota > 0:
                used += take_chunks(req, quota)
            elif req.done_all:
                # zero remaining chunks but the COMPLETION message still has
                # to go out — dropping it here would leak the request
                selected.append(req)

        if used < cap:
            left = cap - used
            for req in background:
                if left <= 0:
                    break
                n = take_chunks(req, left)
                left -= n
                used += n
        for req in background:
            if req.done_all and not any(r is req for r in selected):
                selected.append(req)

        if stats is not None:
            t, c = stats.get("sched.detok_windows_sel", (0.0, 0))
            stats["sched.detok_windows_sel"] = (t + used, c + 1)
        return mini_sel + selected
