"""ModelWorker: a synchronous subset of vox_serve_tpu/worker/base.py.

It keeps the public interface the scheduler calls (``run_lm_prefill``,
``run_lm_decode``, ``run_detokenize``, ``sync``, ``can_admit``,
``free_kv_cache``, ``fail_request``, ``max_prefill_tokens``,
``detokenize_interval``, ``detokenize_overlap``) and the slot-resident
per-request device state: repetition cache, feedback features, last sampled
tokens and codec caches live in tensors with a leading ``max_batch_size``
slot axis; a request is pinned to a slot on admission, and steps gather and
scatter rows by slot id on the device.

Every step runs eagerly and reads its sampled tokens (or PCM) back before
returning, so ``sync`` has nothing to resolve. Not ported yet: fused
multi-step decode, cold-start chains, readback pipelining, CUDA graphs,
bucket lattices, tensor parallelism, weight quantisation, input
streaming and the first-chunk ramp. The scheduler probes
``run_lm_decode_multi``, ``poll_resolved`` and ``run_cold_start`` with
``getattr`` and runs without them.

Batches are not padded to buckets (nothing is compiled per shape); a row
that cannot step (block-table limit, KV backpressure) stays in the batch as
a padded row: seq_len 1 on scratch page 0, slot id ``max_batch_size``,
whose state scatters are filtered out.

Float32 matmuls and convolutions run in full float32 on the card
(``allow_tf32`` off for cuBLAS and cuDNN, set here): the codec runs in
float32 in the JAX reference too, and TF32 would keep ~10 mantissa bits.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..utils import cdiv, get_logger

from ..models.base import BaseLM
from ..ops.attention import AttnMetadata
from ..ops.kernels import DecodeScratch
from ..ops.kv_cache import (KVCacheConfig, PageAllocator, PageAllocatorError,
                            alloc_kv_pages, combined_kv_supported)
from ..params import tree_leaves, tree_map
from ..requests import Request
from ..sampling import init_repetition_cache

#: stateful-codec catch-up: a request with k ready detokenize windows
#: decodes them as ONE (k-1)*step+interval window in its slot (largest
#: k first)
MULTI_CHUNK_KS = (4, 2)


def _pcm16(audio: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16 PCM on the device (clip, scale by 32767,
    truncate toward zero)."""
    return (torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    max_batch_size: int = 8
    num_pages: int = 2048
    page_size: int = 16
    #: longest packed prefill (tokens over all requests of one prefill)
    max_prefill_tokens: int = 1024
    max_prefill_requests: int = 8
    seed: int = 0
    #: quantized KV pool storage: "none", "f8_e4m3" (scale-free float8) or
    #: "int8" (static amax via kv_k_amax/kv_v_amax). Needs the combined
    #: layout; decode dequantizes inside K1q. See ops/kv_cache.py.
    kv_quant: str = "none"
    kv_k_amax: float = 16.0
    kv_v_amax: float = 16.0

    # read by the scheduler; fused decode is not ported
    @property
    def fused_decode_steps(self) -> int:
        return 0

    @property
    def fused_decode_buckets(self) -> tuple[int, ...]:
        return ()

    @property
    def detok_buckets(self) -> tuple[int, ...]:
        return (self.max_batch_size,)


class ModelWorker:
    def __init__(self, model: BaseLM, config: WorkerConfig | None = None):
        self.model = model
        self.config = cfg = config or WorkerConfig()
        self.logger = get_logger("worker")
        self.device = dev = model.device
        #: cumulative wall time per phase: name -> (total_s, calls)
        self.phase_stats: dict[str, tuple[float, int]] = {}
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        bb = model.backbone_config
        head_dim = bb.resolved_head_dim
        combined = combined_kv_supported(head_dim, bb.num_kv_heads, bb.dtype)
        if os.environ.get("VOX_KV_COMBINED", "") in ("0", "false"):
            combined = False  # escape hatch: the legacy pair layout (K4)
        kv_quant = cfg.kv_quant
        if kv_quant != "none":
            # quantized pools need the combined layout AND the 1-byte
            # packing to divide the combined-head axis
            q_dtype = (torch.int8 if kv_quant == "int8"
                       else torch.float8_e4m3fn)
            if not (combined and combined_kv_supported(
                    head_dim, bb.num_kv_heads, q_dtype)):
                self.logger.warning(
                    "kv_quant=%s unsupported for head_dim %d / KH %d; "
                    "serving full-precision KV", kv_quant, head_dim,
                    bb.num_kv_heads)
                kv_quant = "none"
        # Not ported: the JAX worker's fold check of the legacy decode kernel
        # (128 % head_dim, page_size % fold) and its check of prefill buckets
        # against the Pallas prefill tiles; both are TPU tiling rules, and
        # K4 / K3 take any page size, head dim <= 128 and token count.
        self.kv_config = KVCacheConfig(
            num_layers=bb.num_layers, num_pages=cfg.num_pages,
            page_size=cfg.page_size, num_kv_heads=bb.num_kv_heads,
            head_dim=head_dim, dtype=bb.dtype, combined=combined,
            quant=kv_quant, k_amax=cfg.kv_k_amax, v_amax=cfg.kv_v_amax)
        model.kv_quant_scales = self.kv_config.kv_scales
        self.k_pages, self.v_pages = alloc_kv_pages(self.kv_config, dev)
        self.allocator = PageAllocator(cfg.num_pages)
        # block-table limit per sequence: longest prompt + generation budget
        self.max_pages_per_seq = cdiv(
            cfg.max_prefill_tokens + model.max_tokens + 8, cfg.page_size) + 1
        # the decode kernel's split workspace, sized once for the largest
        # decode launch (max batch over the block-table limit)
        self.decode_scratch = None
        if dev.type == "cuda":
            self.decode_scratch = DecodeScratch(
                dev, cfg.max_batch_size, bb.num_heads, bb.num_kv_heads,
                head_dim, self.max_pages_per_seq, cfg.page_size)

        self._free_slots = list(range(cfg.max_batch_size - 1, -1, -1))
        self.rep_cache = None
        if model.use_repetition_penalty:
            sc = model.sampling_config
            self.rep_cache = init_repetition_cache(
                cfg.max_batch_size, sc.cache_window, model.n_codebooks,
                model.vocab_size, dev)
        self.feedback = None
        if model.feedback_dim:
            self.feedback = torch.zeros(
                (cfg.max_batch_size, model.feedback_dim), dtype=bb.dtype,
                device=dev)
        self.last_tokens = torch.zeros(
            (cfg.max_batch_size, model.n_codebooks), dtype=torch.int32,
            device=dev)
        self.codec_cache = model.init_decoder_cache(cfg.max_batch_size)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(cfg.seed)

        def _nbytes(tree):
            return sum(a.numel() * a.element_size()
                       for a in tree_leaves(tree))

        self.logger.info(
            "device %s: params %.2fG + KV pool %.2fG + codec %.2fG + slot "
            "caches %.2fG", dev, _nbytes(model.params) / 2**30,
            _nbytes([self.k_pages, self.v_pages]) / 2**30,
            _nbytes(model.codec_params) / 2**30,
            _nbytes(self.codec_cache) / 2**30)

    # ------------------------------------------------------------------
    # properties mirrored from the model (scheduler-facing)
    # ------------------------------------------------------------------
    @property
    def detokenize_interval(self) -> int:
        return self.model.detokenize_interval

    @property
    def detokenize_overlap(self) -> int:
        return self.model.detokenize_overlap

    @property
    def supports_audio_input(self) -> bool:
        return self.model.supports_audio_input

    @property
    def max_prefill_tokens(self) -> int:
        return self.config.max_prefill_tokens

    def _stat(self, name: str, t0: float) -> None:
        tot, n = self.phase_stats.get(name, (0.0, 0))
        self.phase_stats[name] = (tot + (time.perf_counter() - t0), n + 1)

    # ------------------------------------------------------------------
    # admission / release
    # ------------------------------------------------------------------
    def _gen_reserve_pages(self, prompt_len: int, max_tokens: int) -> int:
        """Pages reserved at admission for the full generation budget, so
        decode-phase page growth cannot exhaust the pool mid-stream."""
        budget = max(max_tokens - prompt_len, 0) + 8
        return cdiv(budget, self.config.page_size) + 1

    def can_admit(self, num_prompt_tokens: int) -> bool:
        prompt_pages = cdiv(max(num_prompt_tokens, 1), self.config.page_size)
        reserve = self._gen_reserve_pages(num_prompt_tokens,
                                          self.model.max_tokens)
        return bool(self._free_slots) and self.allocator.can_reserve(
            prompt_pages + reserve)

    def admit(self, req: Request) -> None:
        if req.slot is not None:
            raise RuntimeError(f"request {req.request_id} already holds a slot")
        req.slot = self._free_slots.pop()

    def fail_request(self, req: Request, reason: str) -> None:
        """Fail one request without touching the rest of the batch."""
        self.logger.error("request %s failed: %s", req.request_id, reason)
        req.done_lm_generation = True
        req.done_all = True
        req.finish_reason = f"error: {reason}"
        self.free_kv_cache(req)

    def free_kv_cache(self, req: Request) -> None:
        if req.kv_pages:
            self.allocator.free(req.kv_pages)
            req.kv_pages = []
        reserved = req.extras.pop("kv_reserved", 0)
        if reserved:
            self.allocator.release_reservation(reserved)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None

    def sync(self) -> None:
        """Every step resolves before it returns; nothing is in flight."""

    # ------------------------------------------------------------------
    # slot-state helpers
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _slot_rows(self, state: torch.Tensor, slots: torch.Tensor
                   ) -> torch.Tensor:
        """Gather per-slot rows; padded rows (slot id max_batch_size) read
        a clamped row that is never written back."""
        return state[torch.clamp(slots, max=state.shape[0] - 1).long()]

    @staticmethod
    def _scatter_rows(state: torch.Tensor, slots: torch.Tensor,
                      rows: torch.Tensor, keep: torch.Tensor) -> None:
        """state[slots[keep]] = rows[keep]: padded rows are filtered out
        (JAX drops out-of-range scatters; torch would raise)."""
        state[slots[keep].long()] = rows[keep].to(state.dtype)

    def _zero_slot_caches(self, slots: list[int]) -> None:
        """Zero the codec-cache rows of freshly assigned slots: a reused
        slot still holds the previous occupant's streaming state."""
        if self.codec_cache is None or not slots:
            return
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        tree_map(lambda a: a.index_fill_(0, idx, 0), self.codec_cache)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def run_lm_prefill(self, requests: list[Request]) -> None:
        requests = self._admit_prefills(requests)
        if not requests:
            return
        t0 = time.perf_counter()
        self._dispatch_prefill(requests)
        self._stat("prefill", t0)

    def _admit_prefills(self, requests: list[Request]) -> list[Request]:
        """Slot assignment, preprocessing, token-budget trim and KV-page
        reservation; returns the requests ready to prefill this step
        (failures are isolated per request, overflow defers)."""
        if not requests:
            return []
        model = self.model
        page_size = self.config.page_size
        fresh_slots: list[int] = []
        admitted_set = []
        for req in requests:
            if req.slot is None:
                if not self._free_slots:
                    break  # defer the rest to the next step
                self.admit(req)
                fresh_slots.append(req.slot)
            admitted_set.append(req)
        self._zero_slot_caches(fresh_slots)

        ready: list[Request] = []
        for req in admitted_set:
            if req.input_tokens is None:
                try:
                    po = model.preprocess(req.prompt, req.audio_path,
                                          **req.model_kwargs)
                    req.input_tokens = np.asarray(po.input_tokens, np.int32)
                    req.input_length = len(req.input_tokens)
                    req.input_features = po.input_features
                    req.input_masks = po.input_masks
                except Exception as e:  # fail only this request
                    self.fail_request(req, f"preprocess failed: {e}")
                    continue
            if req.input_length > self.max_prefill_tokens:
                self.fail_request(
                    req, f"prompt of {req.input_length} tokens exceeds the "
                    f"prefill limit {self.max_prefill_tokens}")
                continue
            ready.append(req)

        # trim so the batch fits the prefill token budget; overflow defers
        batch, total = [], 0
        for req in ready[: self.config.max_prefill_requests]:
            if batch and total + req.input_length > self.max_prefill_tokens:
                break
            total += req.input_length
            batch.append(req)

        admitted: list[Request] = []
        for req in batch:
            if req.kv_pages:
                admitted.append(req)  # retried request, pages already held
                continue
            need = cdiv(req.input_length, page_size)
            reserve = self._gen_reserve_pages(
                req.input_length, model.effective_max_tokens(req))
            if need + reserve > self.allocator.num_pages - 1:
                self.fail_request(
                    req, f"KV demand of {need + reserve} pages exceeds the "
                    f"pool ({self.allocator.num_pages - 1} usable); lower "
                    "max_tokens or raise --max-num-pages")
                continue
            if not self.allocator.can_alloc(need + reserve):
                break  # backpressure: keep slot, retry next step
            req.kv_pages = self.allocator.alloc(need)
            self.allocator.reserve(reserve)
            req.extras["kv_reserved"] = reserve
            req.kv_token_len = req.input_length
            admitted.append(req)
        return admitted

    def _dispatch_prefill(self, requests: list[Request]) -> None:
        model = self.model
        C = model.n_codebooks
        page_size = self.config.page_size
        T = sum(r.input_length for r in requests)
        B = len(requests)
        tokens = np.zeros((T, C), np.int32)
        pos = np.zeros((T,), np.int32)
        seg = np.zeros((T,), np.int32)
        page_ids = np.zeros((T,), np.int32)
        offsets = np.zeros((T,), np.int32)
        last_idx = np.zeros((B,), np.int32)
        slot_ids = np.zeros((B,), np.int32)
        feat = (np.zeros((T, requests[0].input_features.shape[-1]), np.float32)
                if model.needs_input_features else None)
        msk = (np.zeros((T, requests[0].input_masks.shape[-1]), bool)
               if model.needs_input_masks else None)
        cursor = 0
        for i, req in enumerate(requests):
            L = req.input_length
            idx = np.arange(L)
            sl = slice(cursor, cursor + L)
            tokens[sl] = req.input_tokens
            seg[sl] = i
            pos[sl] = idx
            page_ids[sl] = np.asarray(req.kv_pages)[idx // page_size]
            offsets[sl] = idx % page_size
            if feat is not None and req.input_features is not None:
                feat[sl] = req.input_features
            if msk is not None and req.input_masks is not None:
                msk[sl] = req.input_masks
            last_idx[i] = cursor + L - 1
            slot_ids[i] = req.slot
            cursor += L

        meta = AttnMetadata(True, self._tensor(page_ids),
                            self._tensor(offsets),
                            segment_ids=self._tensor(seg),
                            q_positions=self._tensor(pos))
        slots = self._tensor(slot_ids)
        rep_rows = None
        if self.rep_cache is not None:
            # a fresh request has no history: prefill starts from zeros
            rep_rows = torch.zeros((B,) + self.rep_cache.shape[1:],
                                   dtype=self.rep_cache.dtype,
                                   device=self.device)
        out = model.lm_step(
            model.params, self._tensor(tokens), meta.q_positions,
            None if feat is None else self._tensor(feat),
            None if msk is None else self._tensor(msk), meta, self.k_pages,
            self.v_pages, self.generator, rep_rows,
            last_token_idx=self._tensor(last_idx))
        self._commit_step(out, slots, torch.ones_like(slots, dtype=torch.bool))
        sampled = out.sampled.cpu().numpy()
        for i, req in enumerate(requests):
            req.done_lm_prefill = True
            model.update_request_state(req, sampled[i])

    def _commit_step(self, out, slots: torch.Tensor,
                     keep: torch.Tensor) -> None:
        """Scatter the step's per-slot state back (live rows only)."""
        if self.rep_cache is not None and out.repetition_cache is not None:
            self._scatter_rows(self.rep_cache, slots, out.repetition_cache,
                               keep)
        if self.feedback is not None and out.feedback is not None:
            self._scatter_rows(self.feedback, slots, out.feedback, keep)
        self._scatter_rows(self.last_tokens, slots, out.sampled, keep)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def run_lm_decode(self, requests: list[Request]) -> None:
        if not requests:
            return
        t0 = time.perf_counter()
        model = self.model
        cfg = self.config
        B = len(requests)
        positions = np.zeros((B,), np.int32)
        page_ids = np.zeros((B,), np.int32)
        offsets = np.zeros((B,), np.int32)
        seq_lens = np.ones((B,), np.int32)
        slot_ids = np.full((B,), cfg.max_batch_size, np.int32)
        tables: list[list[int]] = [[] for _ in range(B)]
        stepped: list[int] = []
        for i, req in enumerate(requests):
            try:
                if self._plan_decode_row(req, i, positions, page_ids,
                                         offsets, seq_lens, slot_ids):
                    tables[i] = req.kv_pages
                    stepped.append(i)
            except Exception as e:
                # a poisoned request must not fail its co-batched streams;
                # its row stays a padded row
                self.fail_request(req, f"decode planning: {e}")
        if not stepped:
            return
        width = max(1, max(len(t) for t in tables))
        block_tables = np.zeros((B, width), np.int32)
        for i, t in enumerate(tables):
            block_tables[i, :len(t)] = t

        meta = AttnMetadata(False, self._tensor(page_ids),
                            self._tensor(offsets),
                            block_tables=self._tensor(block_tables),
                            seq_lens=self._tensor(seq_lens),
                            decode_scratch=self.decode_scratch)
        slots = self._tensor(slot_ids)
        keep = slots < cfg.max_batch_size
        token_ids = self._slot_rows(self.last_tokens, slots)
        rep_rows = (None if self.rep_cache is None
                    else self._slot_rows(self.rep_cache, slots))
        features = (self._slot_rows(self.feedback, slots)
                    if self.feedback is not None and model.feedback_dim
                    else None)
        out = model.lm_step(model.params, token_ids, self._tensor(positions),
                            features, None, meta, self.k_pages,
                            self.v_pages, self.generator, rep_rows)
        self._commit_step(out, slots, keep)
        sampled = out.sampled.cpu().numpy()
        for i in stepped:
            req = requests[i]
            if not req.done_lm_generation:
                model.update_request_state(req, sampled[i])
        self._stat("decode", t0)

    def _plan_decode_row(self, req: Request, i: int, positions, page_ids,
                         offsets, seq_lens, slot_ids) -> bool:
        """Fill row i for one request; returns False (the row stays padded)
        when it cannot step: block-table limit or KV backpressure."""
        page_size = self.config.page_size
        positions[i] = req.input_length + req.num_generated - 1
        t = req.kv_token_len
        if t >= self.max_pages_per_seq * page_size:
            req.done_lm_generation = True
            req.finish_reason = "length"
            self.logger.warning(
                "request %s hit the KV block-table limit (%d tokens)",
                req.request_id, t)
            return False
        if t % page_size == 0:
            reserved = req.extras.get("kv_reserved", 0)
            try:
                req.kv_pages.extend(
                    self.allocator.alloc(1, reserved=min(reserved, 1)))
            except PageAllocatorError:
                self.logger.warning(
                    "KV pool exhausted; deferring request %s this step",
                    req.request_id)
                return False
            if reserved:
                req.extras["kv_reserved"] = reserved - 1
        page_ids[i] = req.kv_pages[t // page_size]
        offsets[i] = t % page_size
        req.kv_token_len = t + 1
        seq_lens[i] = req.kv_token_len
        slot_ids[i] = req.slot
        return True

    # ------------------------------------------------------------------
    # detokenize
    # ------------------------------------------------------------------
    def run_detokenize(self, requests: list[Request]) -> list[Request]:
        """Decode each request's selected chunk windows into PCM and emit
        them with the reference trim rule. Returns the requests touched."""
        if not requests:
            return []
        t0 = time.perf_counter()
        interval = self.model.detokenize_interval
        step = interval - self.model.detokenize_overlap
        by_len: dict[int, tuple[list, list]] = {}
        finish_check: list[Request] = []
        for req in requests:
            try:
                self._plan_detok_windows(req, by_len, interval, step)
            except Exception as e:
                self.fail_request(req, f"detokenize planning: {e}")
                continue
            finish_check.append(req)
        touched: list[Request] = []
        for length, (wins, maps) in sorted(by_len.items()):
            for r in self._detok_batch(wins, maps):
                if r not in touched:
                    touched.append(r)
        self._maybe_finish(finish_check)
        for r in finish_check:
            if r not in touched:
                touched.append(r)
        if by_len:
            self._stat("detokenize", t0)
        return touched

    def _plan_detok_windows(self, req: Request, by_len: dict, interval: int,
                            step: int) -> None:
        """Collect req's ready chunk windows into by_len (len -> windows)."""
        req.audio_decode_idx = list(req.next_audio_decode_idx)
        if self.codec_cache is not None and len(req.audio_decode_idx) > 1:
            idx = req.audio_decode_idx
            k = next((kk for kk in MULTI_CHUNK_KS
                      if len(idx) >= kk), 1)
            idx = idx[:k]
            req.audio_decode_idx = idx
            req.next_audio_decode_idx = idx
            L = (k - 1) * step + interval
            starts = [idx[0]]
        else:
            L = interval
            starts = req.audio_decode_idx
        for start in starts:
            toks = req.lm_output_audio_tokens[start:start + L]
            if not toks:
                continue
            arr = np.stack(toks, axis=0)
            last_len = len(arr)
            if last_len < L:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], L - last_len, axis=0)], axis=0)
            wins, maps = by_len.setdefault(L, ([], []))
            wins.append(arr)
            maps.append((req, start, last_len, L))

    def _detok_batch(self, windows: list, mapping: list) -> list[Request]:
        """Run the codec over one batch of equal-length windows, each in
        its request's slot cache, and queue the PCM chunks."""
        model = self.model
        token_ids = self._tensor(np.stack(windows, axis=0).astype(np.int32))
        slots = torch.tensor([m[0].slot for m in mapping], dtype=torch.long,
                             device=self.device)
        rows = tree_map(lambda a: a[slots], self.codec_cache)
        audio, new_rows = model.detokenize(model.codec_params, token_ids, rows)
        if self.codec_cache is not None and new_rows is not None:
            def put(a, r):
                a[slots] = r.to(a.dtype)
            tree_map(put, self.codec_cache, new_rows)
        pcm = _pcm16(audio).cpu().numpy()  # (n, channels, samples)
        touched: list[Request] = []
        for i, (req, _start, last_len, window_len) in enumerate(mapping):
            chunk = pcm[i]
            step_len = window_len - model.detokenize_overlap
            if last_len < step_len:  # final partial window: trim
                trim = int(chunk.shape[1] * (last_len - 0.5) / step_len)
                chunk = chunk[:, :max(trim, 0)]
            req.output_audio.put(chunk.tobytes())
            if req not in touched:
                touched.append(req)
        return touched

    def _maybe_finish(self, requests: list[Request]) -> None:
        interval = self.model.detokenize_interval
        for req in requests:
            if req.done_lm_generation and req.audio_decode_idx and (
                    req.audio_decode_idx[-1] + interval
                    >= len(req.lm_output_audio_tokens)):
                req.done_all = True
            elif req.done_lm_generation and not req.lm_output_audio_tokens:
                req.done_all = True
