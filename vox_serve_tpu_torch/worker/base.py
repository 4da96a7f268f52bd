"""ModelWorker: persistent slot state, packed decode steps captured as CUDA
graphs, and pipelined readback (port of vox_serve_tpu/worker/base.py).

It keeps the public interface the scheduler calls (``run_lm_prefill``,
``run_lm_decode``, ``run_lm_decode_multi``, ``can_decode_multi``,
``fused_k_for``, ``run_detokenize``, ``sync``, ``poll_resolved``,
``can_admit``, ``free_kv_cache``, ``fail_request``, ``max_prefill_tokens``,
``detokenize_interval``, ``detokenize_overlap``) and the slot-resident
per-request device state: repetition cache, feedback features, last sampled
tokens and codec caches live in tensors with a leading slot axis; a request
is pinned to a slot on admission, and steps gather and scatter rows by slot
id on the device. The LM-side state has one row more than there are slots,
the sentinel row ``max_batch_size``, which padded batch rows read and write
(JAX's out-of-range ``mode="drop"`` scatters): no step filters rows on the
host, so every step keeps its shapes.

Decode is the JAX worker's compiled-step machinery, with a captured CUDA
graph (``worker/graphs.py``) where JAX has a jitted executable: a single
decode step over one packed int32 upload of shape (B, 2C+6+W), and a fused
k-step decode over one flat upload, per (batch bucket B, block-table width
W[, k]), captured at start-up (``warmup``) or at a key's first use. Batches
are padded to the bucket: padded rows sit on scratch page 0 with seq_len 1
and the sentinel slot. Every tensor a graph reads or writes (parameters,
KV pools, slot state, the decode scratch) is allocated once and only
updated in place, so the captured pointers stay valid; parameters must be
installed before the worker is built. Sampled tokens reach the host through
a pinned buffer and a CUDA event, up to ``pipeline_depth`` steps late
(``_pending``, ``poll_resolved``). On the CPU the same step bodies run
eagerly and every entry is ready at once.

Prefill and detokenize run eagerly (prefill's sampled tokens go through
the same readback pipeline). Not ported yet: prefill graphs, the cold-start
chain, the first-chunk ramp, detokenize graphs and pipelining, input
streaming (the pack's override columns stay zero), tensor parallelism and
weight quantisation.

Float32 matmuls and convolutions run in full float32 on the card
(``allow_tf32`` off for cuBLAS and cuDNN, set here): the codec runs in
float32 in the JAX reference too, and TF32 would keep ~10 mantissa bits.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

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
from .graphs import StepCache

#: stateful-codec catch-up: a request with k ready detokenize windows
#: decodes them as ONE (k-1)*step+interval window in its slot (largest
#: k first)
MULTI_CHUNK_KS = (4, 2)

#: block-table widths are whole multiples of this many tokens (the JAX
#: worker's lattice unit, its Pallas kernel's DMA chunk; kept so that both
#: packages pick the same widths)
CHUNK_TOKENS = 128


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
    #: capture every decode graph at start-up (else at a key's first use)
    warmup: bool = True
    seed: int = 0
    #: in-flight decode steps whose sampled-token readback is deferred; the
    #: feedback token stays on the device (slot buffer), so the next step
    #: launches without waiting for the host. 0 = synchronous.
    pipeline_depth: int = 0
    #: quantized KV pool storage: "none", "f8_e4m3" (scale-free float8) or
    #: "int8" (static amax via kv_k_amax/kv_v_amax). Needs the combined
    #: layout; decode dequantizes inside K1q. See ops/kv_cache.py.
    kv_quant: str = "none"
    kv_k_amax: float = 16.0
    kv_v_amax: float = 16.0
    #: explicit decode-bucket lattice (ascending, last = max_batch_size);
    #: None -> powers of 2 up to max_batch_size
    decode_buckets_override: Optional[tuple[int, ...]] = None
    #: block-table width lattice (pages); each step runs at the smallest
    #: width covering its batch. None -> geometric from the first-chunk
    #: floor up to the block-table limit.
    table_width_buckets: Optional[tuple[int, ...]] = None
    #: fused multi-step decode: k decode steps in one graph (0 disables)
    fused_decode_steps: int = 0
    #: batch buckets with fused graphs
    fused_decode_buckets: tuple[int, ...] = (1,)
    #: per-bucket fused step count (one k per fused bucket, each <=
    #: fused_decode_steps); None -> fused_decode_steps everywhere
    fused_k_schedule: Optional[tuple[int, ...]] = None
    #: latency/throughput regime boundary the scheduler reads (None = none)
    fused_min_batch: Optional[int] = None

    @property
    def decode_buckets(self) -> tuple[int, ...]:
        if self.decode_buckets_override is not None:
            if self.decode_buckets_override[-1] != self.max_batch_size:
                raise ValueError(
                    f"decode buckets {self.decode_buckets_override} must end "
                    f"at max_batch_size {self.max_batch_size}")
            return tuple(self.decode_buckets_override)
        b, out = 1, []
        while b < self.max_batch_size:
            out.append(b)
            b *= 2
        out.append(self.max_batch_size)
        return tuple(out)

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

        if cfg.fused_k_schedule is not None:
            if len(cfg.fused_k_schedule) != len(cfg.fused_decode_buckets):
                raise ValueError(
                    f"fused_k_schedule {cfg.fused_k_schedule} must have one "
                    f"k per fused bucket {cfg.fused_decode_buckets}")
            if any(k < 1 or k > max(1, cfg.fused_decode_steps)
                   for k in cfg.fused_k_schedule):
                raise ValueError(
                    f"fused_k_schedule entries must be in [1, "
                    f"fused_decode_steps={cfg.fused_decode_steps}] "
                    f"(got {cfg.fused_k_schedule}); fused_decode_steps "
                    "sizes the per-request scratch-page reserve")

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
        self._init_width_lattice()
        # the decode kernel's split workspace, sized once for the largest
        # decode launch (widest bucket over the block-table limit)
        self.decode_scratch = None
        if dev.type == "cuda":
            self.decode_scratch = DecodeScratch(
                dev, max((cfg.max_batch_size, *cfg.fused_decode_buckets)),
                bb.num_heads, bb.num_kv_heads, head_dim,
                self.max_pages_per_seq, cfg.page_size)

        self._free_slots = list(range(cfg.max_batch_size - 1, -1, -1))
        # LM-side slot state: one row per slot plus the sentinel row
        # (index max_batch_size) that padded rows gather from and scatter to
        rows = cfg.max_batch_size + 1
        self.rep_cache = None
        if model.use_repetition_penalty:
            sc = model.sampling_config
            self.rep_cache = init_repetition_cache(
                rows, sc.cache_window, model.n_codebooks, model.vocab_size,
                dev)
        self.feedback = None
        if model.feedback_dim:
            self.feedback = torch.zeros((rows, model.feedback_dim),
                                        dtype=bb.dtype, device=dev)
        self.last_tokens = torch.zeros((rows, model.n_codebooks),
                                       dtype=torch.int32, device=dev)
        self.codec_cache = model.init_decoder_cache(cfg.max_batch_size)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(cfg.seed)

        #: decode steps awaiting host readback, oldest first:
        #: (host tokens, event or None, requests, hard-stopped rows, k)
        self._pending: list[tuple] = []
        #: decode-body calls on the card outside a capture (must stay 0)
        self.eager_decode_steps = 0
        #: most steps in flight after a dispatch; entries poll_resolved
        #: resolved
        self.max_pending = 0
        self.polled = 0
        self._steps = StepCache(dev, self._build_step, self.generator,
                                cfg.pipeline_depth + 2)

        def _nbytes(tree):
            return sum(a.numel() * a.element_size()
                       for a in tree_leaves(tree))

        self.logger.info(
            "device %s: params %.2fG + KV pool %.2fG + codec %.2fG + slot "
            "caches %.2fG; decode buckets %s, table widths %s", dev,
            _nbytes(model.params) / 2**30,
            _nbytes([self.k_pages, self.v_pages]) / 2**30,
            _nbytes(model.codec_params) / 2**30,
            _nbytes(self.codec_cache) / 2**30, cfg.decode_buckets,
            self.table_width_buckets)
        if cfg.warmup:
            self.warmup()

    def _init_width_lattice(self) -> None:
        """Block-table limit and width lattice (JAX worker, with
        max_prefill_tokens for the largest prefill bucket): the limit
        covers the longest prompt plus the full generation budget, rounded
        up to whole chunks; the smallest width covers any first-chunk
        stream (longest prompt + two detokenize intervals or fused steps)."""
        cfg, model = self.config, self.model
        width = cdiv(cfg.max_prefill_tokens + model.max_tokens + 8,
                     cfg.page_size) + 1
        chunk_pages = max(1, CHUNK_TOKENS // cfg.page_size)
        self.max_pages_per_seq = cdiv(width, chunk_pages) * chunk_pages
        floor = cdiv(
            cdiv(cfg.max_prefill_tokens
                 + 2 * max(model.detokenize_interval,
                           cfg.fused_decode_steps) + 8,
                 cfg.page_size) + 1,
            chunk_pages) * chunk_pages
        floor = min(floor, self.max_pages_per_seq)
        if cfg.table_width_buckets is not None:
            widths = tuple(w for w in cfg.table_width_buckets if w > 0)
            buckets = sorted(
                set(min(cdiv(w, chunk_pages) * chunk_pages,
                        self.max_pages_per_seq) for w in widths)) or [
                self.max_pages_per_seq]
            if buckets[0] < floor:
                self.logger.warning(
                    "table_width_buckets smallest width %d is below the "
                    "first-chunk floor %d pages; raising it", buckets[0],
                    floor)
                buckets = sorted({max(b, floor) for b in buckets})
            self.table_width_buckets = tuple(buckets)
        else:
            w, widths = floor, []
            while w < self.max_pages_per_seq:
                widths.append(w)
                w *= 2
            widths.append(self.max_pages_per_seq)
            self.table_width_buckets = tuple(widths)
        if self.table_width_buckets[-1] != self.max_pages_per_seq:
            self.table_width_buckets += (self.max_pages_per_seq,)

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
        if req.extras.get("inflight"):
            self.sync()  # its in-flight steps still write its pages
        if req.kv_pages:
            self.allocator.free(req.kv_pages)
            req.kv_pages = []
        reserved = req.extras.pop("kv_reserved", 0)
        if reserved:
            self.allocator.release_reservation(reserved)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None

    # ------------------------------------------------------------------
    # slot-state helpers
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # a pageable copy would wait for every step in flight
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _commit_step(self, out, slots: torch.Tensor) -> None:
        """Scatter a step's per-slot state back in place (padded rows land
        on the sentinel row)."""
        if self.rep_cache is not None and out.repetition_cache is not None:
            self.rep_cache[slots] = out.repetition_cache
        if self.feedback is not None and out.feedback is not None:
            self.feedback[slots] = out.feedback.to(self.feedback.dtype)
        self.last_tokens[slots] = out.sampled

    def _zero_slot_caches(self, slots: list[int]) -> None:
        """Zero the codec-cache rows of freshly assigned slots: a reused
        slot still holds the previous occupant's streaming state."""
        if self.codec_cache is None or not slots:
            return
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        tree_map(lambda a: a.index_fill_(0, idx, 0), self.codec_cache)

    # ------------------------------------------------------------------
    # readback pipeline
    # ------------------------------------------------------------------
    def _push_pending(self, sampled: torch.Tensor, requests: list[Request],
                      hard_stopped: set[int], n_steps: int) -> None:
        """Queue a step's sampled tokens for readback: on the card a
        non-blocking copy into pinned memory and an event after it."""
        event = None
        if self.device.type == "cuda":
            host = torch.empty(sampled.shape, dtype=sampled.dtype,
                               pin_memory=True)
            host.copy_(sampled, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = sampled
        self._pending.append((host, event, list(requests), hard_stopped,
                              n_steps))
        self.max_pending = max(self.max_pending, len(self._pending))

    def _drain(self, depth: int) -> None:
        while len(self._pending) > depth:
            self._resolve_one()

    def _resolve_one(self) -> None:
        host, event, requests, hard_stopped, n_steps = self._pending.pop(0)
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        # a copy: the pinned buffer returns to its allocator once dropped
        sampled = host.numpy().reshape(n_steps, -1, host.shape[-1]).copy()
        self._stat("resolve.tokens_get", t0)
        for i, req in enumerate(requests):
            if i in hard_stopped:
                # never fed this step (hard stop or KV backpressure), so no
                # inflight increment happened: no decrement either
                continue
            req.extras["inflight"] = max(
                req.extras.get("inflight", n_steps) - n_steps, 0)
            for s in range(n_steps):
                if req.done_lm_generation:
                    break  # steps issued past the stop point are discarded
                self.model.update_request_state(req, sampled[s, i])

    def sync(self) -> None:
        """Resolve all in-flight steps (host state catches up)."""
        self._drain(0)

    def poll_resolved(self) -> list[Request]:
        """Resolve, without blocking, the in-flight steps whose device work
        is done, oldest first (the device runs them in order, so the first
        that is not done ends the poll). No LM entry carries audio, so no
        request is returned."""
        while self._pending:
            event = self._pending[0][1]
            if event is not None and not event.query():
                break
            self._resolve_one()
            self.polled += 1
        return []

    # ------------------------------------------------------------------
    # prefill (eager)
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
        slots = self._tensor(slot_ids).long()
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
        self._commit_step(out, slots)
        # the first decode reads the sampled token from the slot buffer, so
        # the host copy goes through the readback pipeline like a decode's
        for req in requests:
            req.done_lm_prefill = True
            req.extras["inflight"] = req.extras.get("inflight", 0) + 1
        self._push_pending(out.sampled, requests, set(), 1)
        self._drain(self.config.pipeline_depth)

    # ------------------------------------------------------------------
    # decode steps (one graph per key on the card)
    # ------------------------------------------------------------------
    def _decode_bucket(self, n: int) -> int:
        for b in self.config.decode_buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds max_batch_size")

    def _table_width(self, requests: list[Request], k: int = 1) -> int:
        """Smallest lattice block-table width covering every request's pages
        after k more tokens (the decode kernel's split plan follows the
        table's width)."""
        need = 1
        page_size = self.config.page_size
        for r in requests:
            need = max(need, len(r.kv_pages),
                       cdiv(r.kv_token_len + k, page_size))
        for w in self.table_width_buckets:
            if need <= w:
                return w
        return self.max_pages_per_seq

    @staticmethod
    def _decode_pack_views(pack, C: int):
        """Column views of the single-step pack (B, 2C+6+W), numpy on the
        host or torch on the device: overrides, override mask, gen_idx,
        positions, page ids, offsets, seq_lens, slot ids, block tables."""
        return (pack[:, 0:C], pack[:, C:2 * C], pack[:, 2 * C + 0],
                pack[:, 2 * C + 1], pack[:, 2 * C + 2], pack[:, 2 * C + 3],
                pack[:, 2 * C + 4], pack[:, 2 * C + 5], pack[:, 2 * C + 6:])

    @staticmethod
    def _multi_pack_views(pack, K: int, B: int, C: int, maxP: int):
        """Views into the flat fused-decode pack, numpy on the host or torch
        on the device (the JAX worker's ``_multi_pack_views`` /
        ``_unpack_multi``)."""
        o = 0
        overrides = pack[o:o + K * B * C].reshape(K, B, C); o += K * B * C
        override_mask = pack[o:o + K * B * C].reshape(K, B, C); o += K * B * C
        positions = pack[o:o + K * B].reshape(K, B); o += K * B
        page_ids = pack[o:o + K * B].reshape(K, B); o += K * B
        offsets = pack[o:o + K * B].reshape(K, B); o += K * B
        gen_idx0 = pack[o:o + B]; o += B
        seq_lens0 = pack[o:o + B]; o += B
        slot_ids = pack[o:o + B]; o += B
        block_tables = pack[o:o + B * maxP].reshape(B, maxP); o += B * maxP
        if o != pack.shape[0]:
            raise ValueError(f"fused pack of {pack.shape[0]} ints, expected "
                             f"{o} for K={K} B={B} C={C} W={maxP}")
        return (overrides, override_mask, positions, page_ids, offsets,
                gen_idx0, seq_lens0, slot_ids, block_tables)

    def _padded_pack(self, key: tuple) -> np.ndarray:
        """A fully padded pack for ``key`` (every row on scratch page 0,
        seq_len 1, the sentinel slot): warm-up and probe input."""
        C = self.model.n_codebooks
        if key[0] == "decode":
            _, B, W = key
            pack = np.zeros((B, 2 * C + 6 + W), np.int32)
            views = self._decode_pack_views(pack, C)
        else:
            _, B, K, W = key
            pack = np.zeros((2 * K * B * C + 3 * K * B + B * (3 + W),),
                            np.int32)
            views = self._multi_pack_views(pack, K, B, C, W)
        views[6][:] = 1  # seq_lens
        views[7][:] = self.config.max_batch_size  # slot ids
        return pack

    def _count_eager(self) -> None:
        if self.device.type == "cuda" and not self._steps.capturing:
            self.eager_decode_steps += 1

    def _lm_decode(self, overrides, override_mask, positions, meta,
                   slots) -> torch.Tensor:
        """One decode step over the slots' rows: feed each slot's last
        sampled tokens (or the pack's overrides), run the model, scatter the
        state back in place. Returns the sampled (B, C) tokens."""
        model = self.model
        token_ids = torch.where(override_mask != 0, overrides,
                                self.last_tokens[slots])
        rep_rows = None if self.rep_cache is None else self.rep_cache[slots]
        features = (self.feedback[slots]
                    if self.feedback is not None and model.feedback_dim
                    else None)
        out = model.lm_step(model.params, token_ids, positions, features,
                            None, meta, self.k_pages, self.v_pages,
                            self.generator, rep_rows)
        self._commit_step(out, slots)
        return out.sampled

    def _build_step(self, key: tuple):
        """(body, padded pack) of a step key: ("decode", B, W) unpacks the
        (B, 2C+6+W) pack on the device (``_build_lm_decode_fn``);
        ("decode_multi", B, K, W) runs K single-step bodies in a row over
        the flat pack, seq_lens advancing on the device
        (``_build_lm_multi_fn``). The gen_idx columns keep the JAX layout;
        no ported model reads them."""
        C = self.model.n_codebooks
        scratch = self.decode_scratch
        if key[0] == "decode":
            def body(pack: torch.Tensor) -> torch.Tensor:
                self._count_eager()
                (overrides, override_mask, _gen_idx, positions, page_ids,
                 offsets, seq_lens, slot_ids, tables) = \
                    self._decode_pack_views(pack, C)
                meta = AttnMetadata(False, page_ids, offsets,
                                    block_tables=tables.contiguous(),
                                    seq_lens=seq_lens.contiguous(),
                                    decode_scratch=scratch)
                return self._lm_decode(overrides, override_mask, positions,
                                       meta, slot_ids.long())
        else:
            _, B, K, W = key

            def body(pack: torch.Tensor) -> torch.Tensor:
                self._count_eager()
                (overrides, override_mask, positions, page_ids, offsets,
                 _gen_idx0, seq_lens0, slot_ids, tables) = \
                    self._multi_pack_views(pack, K, B, C, W)
                slots = slot_ids.long()
                sampled = []
                for i in range(K):
                    meta = AttnMetadata(False, page_ids[i], offsets[i],
                                        block_tables=tables,
                                        seq_lens=seq_lens0 + i,
                                        decode_scratch=scratch)
                    sampled.append(self._lm_decode(
                        overrides[i], override_mask[i], positions[i], meta,
                        slots))
                return torch.stack(sampled)
        return body, self._padded_pack(key)

    def _plan_decode(self, requests: list[Request], B: int, W: int
                     ) -> tuple[np.ndarray, set[int]]:
        """The single-step pack for a batch padded to bucket B over width
        W, and the rows that do not step."""
        C = self.model.n_codebooks
        packed = np.zeros((B, 2 * C + 6 + W), np.int32)
        (overrides, override_mask, gen_idx, positions, page_ids, offsets,
         seq_lens, slot_ids, block_tables) = self._decode_pack_views(packed, C)
        seq_lens[:] = 1
        slot_ids[:] = self.config.max_batch_size
        hard_stopped: set[int] = set()
        for i, req in enumerate(requests):
            try:
                self._plan_decode_row(req, i, gen_idx, positions, page_ids,
                                      offsets, block_tables, seq_lens,
                                      slot_ids, hard_stopped)
            except Exception as e:
                # a poisoned request must not fail its co-batched streams;
                # its row stays a padded row
                self.fail_request(req, f"decode planning: {e}")
                hard_stopped.add(i)
        return packed, hard_stopped

    def _plan_decode_row(self, req: Request, i: int, gen_idx, positions,
                         page_ids, offsets, block_tables, seq_lens, slot_ids,
                         hard_stopped: set[int]) -> None:
        """Fill row i for one request. A request that cannot step
        (block-table limit, KV backpressure) joins hard_stopped and keeps
        its padded row."""
        page_size = self.config.page_size
        inflight = req.extras.get("inflight", 0)
        # the position of the token fed this step counts the steps still
        # in flight
        gen_idx[i] = req.num_generated + inflight
        positions[i] = req.input_length + gen_idx[i] - 1
        t = req.kv_token_len
        if t >= self.max_pages_per_seq * page_size:
            # resolve the steps in flight first: a stop set while they are
            # unresolved would make _resolve_one discard their tokens
            self.sync()
            req.done_lm_generation = True
            req.finish_reason = "length"
            self.logger.warning(
                "request %s hit the KV block-table limit (%d tokens)",
                req.request_id, t)
            hard_stopped.add(i)
            return
        if t % page_size == 0:
            reserved = req.extras.get("kv_reserved", 0)
            try:
                req.kv_pages.extend(
                    self.allocator.alloc(1, reserved=min(reserved, 1)))
            except PageAllocatorError:
                self.logger.warning(
                    "KV pool exhausted; deferring request %s this step",
                    req.request_id)
                hard_stopped.add(i)
                return
            if reserved:
                req.extras["kv_reserved"] = reserved - 1
        page_ids[i] = req.kv_pages[t // page_size]
        offsets[i] = t % page_size
        req.kv_token_len = t + 1
        block_tables[i, :len(req.kv_pages)] = req.kv_pages
        seq_lens[i] = req.kv_token_len
        slot_ids[i] = req.slot
        req.extras["inflight"] = inflight + 1

    def run_lm_decode(self, requests: list[Request]) -> None:
        if not requests:
            return
        t0 = time.perf_counter()
        B = self._decode_bucket(len(requests))
        W = self._table_width(requests)
        packed, hard_stopped = self._plan_decode(requests, B, W)
        self._stat("decode.plan", t0)
        t0 = time.perf_counter()
        sampled = self._steps.run(("decode", B, W), packed)
        self._push_pending(sampled, requests, hard_stopped, 1)
        self._stat("decode.dispatch", t0)
        t0 = time.perf_counter()
        self._drain(self.config.pipeline_depth)
        self._stat("decode.resolve", t0)

    # ------------------------------------------------------------------
    # fused multi-step decode (k steps in one graph)
    # ------------------------------------------------------------------
    def _fused_bucket(self, n: int) -> Optional[int]:
        for b in self.config.fused_decode_buckets:
            if n <= b:
                return b
        return None

    def fused_k_for(self, n: int) -> int:
        """Scheduled fused step count for a decode batch of n requests
        (see WorkerConfig.fused_k_schedule). 1 = single-step rounds."""
        cfg = self.config
        if not cfg.fused_decode_steps:
            return 1
        b = self._fused_bucket(n)
        if b is None:
            return 1
        if cfg.fused_k_schedule:
            return cfg.fused_k_schedule[cfg.fused_decode_buckets.index(b)]
        return cfg.fused_decode_steps

    def can_decode_multi(self, requests: list[Request], n_steps: int) -> bool:
        """True iff every request can take n_steps KV tokens without
        crossing its block-table limit, the batch fits a fused bucket, and
        (under a fused-k schedule) n_steps is one of the bucket's captured
        step counts."""
        if not self.config.fused_decode_steps or n_steps < 2:
            return False
        if self._fused_bucket(len(requests)) is None:
            return False
        if (self.config.fused_k_schedule
                and n_steps not in (self.fused_k_for(len(requests)),
                                    self.config.fused_decode_steps)):
            return False
        limit = self.max_pages_per_seq * self.config.page_size
        return all(r.kv_token_len + n_steps <= limit for r in requests)

    def run_lm_decode_multi(self, requests: list[Request],
                            n_steps: int) -> None:
        """Run n_steps decode steps for the batch in ONE graph replay.
        Callers check ``can_decode_multi``. KV pages for all k tokens are
        allocated up front; allocator backpressure leaves a request out of
        the whole fused call (padded row)."""
        if not requests:
            return
        K = n_steps
        B = self._fused_bucket(len(requests))
        if B is None:
            raise ValueError(f"no fused bucket holds {len(requests)} rows")
        t0 = time.perf_counter()
        W = self._table_width(requests, K)
        pack, hard_stopped = self._plan_decode_multi(requests, K, B, W)
        self._stat("decode_multi.plan", t0)
        t0 = time.perf_counter()
        sampled = self._steps.run(("decode_multi", B, K, W), pack)
        self._push_pending(sampled, requests, hard_stopped, K)
        self._stat("decode_multi.dispatch", t0)
        t0 = time.perf_counter()
        self._drain(self.config.pipeline_depth)
        self._stat("decode_multi.resolve", t0)

    def _plan_decode_multi(self, requests: list[Request], K: int, B: int,
                           width: int | None = None
                           ) -> tuple[np.ndarray, set[int]]:
        """Host planning for a fused k-step decode: preallocate KV pages for
        all K tokens per request and fill the (K, B) per-step metadata, all
        of it views into ONE flat int32 pack whose block-table width is the
        smallest covering lattice width."""
        C = self.model.n_codebooks
        page_size = self.config.page_size
        maxP = width or self._table_width(requests, K)
        pack = np.zeros((2 * K * B * C + 3 * K * B + B * (3 + maxP),),
                        np.int32)
        (_overrides, _override_mask, positions, page_ids, offsets, gen_idx0,
         seq_lens0, slot_ids, block_tables) = self._multi_pack_views(
            pack, K, B, C, maxP)
        seq_lens0[:] = 1
        slot_ids[:] = self.config.max_batch_size

        hard_stopped: set[int] = set()
        for i, req in enumerate(requests):
            inflight = req.extras.get("inflight", 0)
            base_gen = req.num_generated + inflight
            t = req.kv_token_len
            new_pages_needed = sum(
                1 for s in range(K) if (t + s) % page_size == 0)
            if new_pages_needed:
                reserved = req.extras.get("kv_reserved", 0)
                try:
                    got = self.allocator.alloc(
                        new_pages_needed,
                        reserved=min(reserved, new_pages_needed))
                except PageAllocatorError:
                    self.logger.warning(
                        "KV pool exhausted; deferring request %s this step",
                        req.request_id)
                    hard_stopped.add(i)
                    continue
                req.kv_pages.extend(got)
                req.extras["kv_reserved"] = max(
                    reserved - new_pages_needed, 0)
            gen_idx0[i] = base_gen
            for s in range(K):
                positions[s, i] = req.input_length + base_gen + s - 1
                tt = t + s
                page_ids[s, i] = req.kv_pages[tt // page_size]
                offsets[s, i] = tt % page_size
            req.kv_token_len = t + K
            block_tables[i, :len(req.kv_pages)] = req.kv_pages
            seq_lens0[i] = t + 1
            slot_ids[i] = req.slot
            req.extras["inflight"] = inflight + K
        return pack, hard_stopped

    # ------------------------------------------------------------------
    # start-up capture
    # ------------------------------------------------------------------
    def warmup_keys(self) -> list[tuple]:
        """Every decode step key: (bucket x width) single steps, then
        (fused bucket x k x width) fused steps, where a bucket under a
        k-schedule takes both its k and fused_decode_steps (>= 2)."""
        cfg = self.config
        keys = [("decode", B, W) for B in cfg.decode_buckets
                for W in self.table_width_buckets]
        K = cfg.fused_decode_steps
        if K >= 2:
            for Bi, B in enumerate(cfg.fused_decode_buckets):
                KB = cfg.fused_k_schedule[Bi] if cfg.fused_k_schedule else K
                for k in sorted({k for k in (KB, K) if k >= 2}):
                    keys += [("decode_multi", B, k, W)
                             for W in self.table_width_buckets]
        return keys

    def warmup(self) -> None:
        """Capture every decode graph up front with fully padded batches
        (scratch page 0, sentinel slot: serving state is untouched) and log
        each graph's device ms per replay. On the CPU there is nothing to
        capture: steps run eagerly."""
        if self.device.type != "cuda":
            self.logger.info("warmup: decode steps run eagerly on %s",
                             self.device)
            return
        t0 = time.monotonic()
        for key in self.warmup_keys():
            ms = self._steps.probe(key)
            self.logger.info("warmup: %s captured (%.3f ms/replay)", key, ms)
        self.logger.info(
            "warmup done in %.1fs: %d graphs, capture %.1fs, graph pool "
            "%.1f MiB", time.monotonic() - t0, len(self._steps.steps),
            self._steps.capture_s, self._steps.pool_bytes() / 2**20)

    def step_stats(self) -> dict:
        """Decode-step counters for the daemon's stats file."""
        steps = self._steps
        return {
            "graphs": [list(k) for k in steps.steps],
            "replays": steps.replays(),
            "decode_steps": steps.decode_steps(),
            "eager_decode_steps": self.eager_decode_steps,
            "capture_s": steps.capture_s,
            "probe_ms": {" ".join(map(str, k)): ms
                         for k, ms in steps.probe_ms.items()},
            "max_pending": self.max_pending,
            "polled": self.polled,
        }

    def reset_step_stats(self) -> None:
        """Zero the per-run counters (phase times, replays, eager steps,
        pipeline depth seen): what a served run reports starts here."""
        self.phase_stats.clear()
        self._steps.reset_counts()
        self.eager_decode_steps = 0
        self.max_pending = 0
        self.polled = 0

    # ------------------------------------------------------------------
    # detokenize (eager)
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
