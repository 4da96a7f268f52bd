"""ModelWorker: persistent slot state, every device step a captured CUDA
graph, and pipelined readback (port of vox_serve_tpu/worker/base.py).

It keeps the public interface the schedulers call (``run_lm_prefill``,
``run_lm_decode``, ``run_lm_decode_multi``, ``can_decode_multi``,
``fused_k_for``, ``can_cold_start``, ``run_cold_start``,
``run_detokenize``, ``flush_detokenize``, ``sync``, ``poll_resolved``,
``can_admit``, ``free_kv_cache``, ``fail_request``, ``max_prefill_tokens``,
``first_chunk_frames``, ``ramp_frames``, ``detokenize_interval``,
``detokenize_overlap``) and the slot-resident per-request device state:
repetition cache, feedback features, last sampled tokens and codec caches
live in tensors with a leading slot axis; a request is pinned to a slot on
admission, and steps gather and scatter rows by slot id on the device.
Every slot tensor has one row more than there are slots, the sentinel row
``max_batch_size``, which padded batch rows read and write (JAX's
out-of-range ``mode="clip"`` gathers and ``mode="drop"`` scatters): no step
filters rows on the host, so every step keeps its shapes.

The device steps are the JAX worker's compiled steps, with a captured CUDA
graph (``worker/graphs.py``) where JAX has a jitted executable, each over
one packed int32 upload (plus the model's feature and mask planes for a
prefill):

* prefill per token bucket T, B = ``max_prefill_requests`` rows
  (``_prefill_host_arrays``: padded tokens are segment -1 on scratch page
  0, padded rows the sentinel slot);
* single-step decode per (batch bucket B, block-table width W) and fused
  k-step decode per (B, k, W);
* ``decode_multi_detok``: a fused first-chunk decode whose k frames (the
  prefill's sample and the first k-1 steps) go straight into the codec;
* the cold-start chain: prefill + fused decode + first-chunk detokenize in
  one graph over the two packs, staged as one buffer;
* detokenize per (detokenize bucket B, window length L): slot gather,
  codec, int16 PCM, slot scatter.

All are captured at start-up (``warmup``) or at a key's first use. Every
tensor a graph reads or writes (parameters, KV pools, slot state, the
decode scratch) is allocated once and only updated in place, so the
captured pointers stay valid; parameters must be installed before the
worker is built. Sampled tokens and PCM reach the host through pinned
buffers and a CUDA event: decode entries up to ``pipeline_depth`` steps
late (``_pending``), detokenize batches up to ``detok_pipeline_depth``
(``_pending_detok``); ``poll_resolved`` surfaces what the device finished.
On the CPU the same step bodies run eagerly and every entry is ready at
once.

The first-chunk ramp (``first_chunk_frames``, ``ramp_frames``) decodes a
new stream's first frames in short windows (F, F, 2F, ... frames) through
the mini detokenize graphs before regular windows take over; the online
scheduler selects them.

Streamed text input (the ``input_streaming`` scheduler): a decode row of
an input-streaming request takes its next queued text token (then the
model's text EOS once, then pad) in the pack's override columns of the
model's text channel (``_inject_streaming_text_token``), planned after the
row's hard-stop and KV backpressure checks so that a row that does not
step consumes nothing.

A model with ``needs_watermarking`` has every decoded chunk watermarked in
``_detok_rows`` (``watermark/``: parameters made at start-up on the device
from ``seed + 101``, float32 whatever the codec's dtype), so the mark is
inside every graph that runs the codec: detokenize, the chained
first-chunk decode and the cold chain.

``codec_dtype`` serves the codec at another dtype ("bfloat16"): every
float32 leaf of the codec parameters and of the codec cache is cast before
the cache is built and before any graph is captured, so graphs and K2's
packed weights read the cast tensors. ``kv_reserve_fraction`` below 1
overcommits the KV pool: admission reserves that share of a request's
generation budget, and a decode row that finds no page is deferred until a
completion frees one. ``enable_profiling`` wraps each step dispatch in a
``torch.profiler.record_function`` range (the JAX worker's trace
annotations).

Not ported: tensor parallelism and weight quantisation.

Float32 matmuls and convolutions run in full float32 on the card
(``allow_tf32`` off for cuBLAS and cuDNN, set here): the codec runs in
float32 in the JAX reference too, and TF32 would keep ~10 mantissa bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from ..utils import cdiv, get_logger

from ..models.base import BaseLM
from ..ops.attention import AttnMetadata
from ..ops.kernels import DecodeScratch
from ..ops.kv_cache import (KVCacheConfig, PageAllocator, PageAllocatorError,
                            alloc_kv_pages, combined_kv_supported)
from ..params import tree_leaves, tree_map
from ..models.backbone import seeded_generator
from ..requests import Request
from ..sampling import init_repetition_cache
from ..watermark import WatermarkConfig, apply_watermark, init_watermarker
from .graphs import StepCache

#: block-table widths are whole multiples of this many tokens (the JAX
#: worker's lattice unit, its Pallas kernel's DMA chunk; kept so that both
#: packages pick the same widths)
CHUNK_TOKENS = 128

#: step kinds (the first element of a step key)
STEP_KINDS = ("prefill", "decode", "decode_multi", "decode_multi_detok",
              "cold_chain", "detok")


def _pcm16(audio: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16 PCM on the device (clip, scale by 32767,
    truncate toward zero)."""
    return (torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    max_batch_size: int = 8
    num_pages: int = 2048
    page_size: int = 16
    #: a prefill runs at the smallest token bucket holding its prompts; the
    #: largest bounds one prefill (and the block-table floor)
    prefill_token_buckets: tuple[int, ...] = (128, 1024)
    max_prefill_requests: int = 8
    #: capture every graph at start-up (else at a key's first use)
    warmup: bool = True
    seed: int = 0
    #: in-flight decode steps whose sampled-token readback is deferred; the
    #: feedback token stays on the device (slot buffer), so the next step
    #: launches without waiting for the host. 0 = synchronous.
    pipeline_depth: int = 0
    #: in-flight detokenize batches with deferred audio readback (0 when
    #: pipeline_depth is 0; else at least 1)
    detok_pipeline_depth: int = 1
    #: TTFA: emit a stream's first chunk after this many frames (0 = the
    #: first chunk waits for a full detokenize window)
    first_chunk_frames: int = 0
    #: frames the mini-chunk ramp covers before regular windows take over
    #: (0 -> one detokenize_interval)
    ramp_frames: int = 0
    #: stateful-codec catch-up: a request with k ready windows decodes them
    #: as ONE (k-1)*step+interval window in its slot (largest k first;
    #: () disables)
    multi_chunk_ks: tuple[int, ...] = (4, 2)
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
    #: detokenize-batch lattice (ascending; the last may be below
    #: max_batch_size, wider batches split). None -> the decode lattice.
    detok_buckets_override: Optional[tuple[int, ...]] = None
    #: ceiling on B * length frames per detokenize graph (the smallest
    #: bucket is always allowed; wider batches split). 0 disables.
    detok_frame_budget: int = 1024
    #: fused multi-step decode: k decode steps in one graph (0 disables)
    fused_decode_steps: int = 0
    #: batch buckets with fused graphs
    fused_decode_buckets: tuple[int, ...] = (1,)
    #: per-bucket fused step count (one k per fused bucket, each <=
    #: fused_decode_steps); None -> fused_decode_steps everywhere
    fused_k_schedule: Optional[tuple[int, ...]] = None
    #: latency/throughput regime boundary the scheduler reads (None = none)
    fused_min_batch: Optional[int] = None
    #: share of the worst-case generation budget reserved at admission. 1.0
    #: = decode page growth can never exhaust the pool; < 1.0 overcommits
    #: for more concurrency, and a shortfall defers the request's decode
    #: step until a completion frees pages.
    kv_reserve_fraction: float = 1.0
    #: serve the codec at this dtype ("bfloat16"); None keeps its own
    codec_dtype: Optional[str] = None
    #: torch.profiler ranges around each step dispatch (off: none)
    enable_profiling: bool = False

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
        if self.detok_buckets_override is not None:
            if self.detok_buckets_override[-1] > self.max_batch_size:
                raise ValueError(
                    f"detok buckets {self.detok_buckets_override} exceed "
                    f"max_batch_size {self.max_batch_size}")
            return tuple(self.detok_buckets_override)
        return self.decode_buckets


@dataclasses.dataclass
class _Pending:
    """An LM step awaiting readback: its sampled tokens (pinned host copy
    on the card), the event after the copies, and for chained first-chunk
    steps the PCM of frames 0..window-1."""
    tokens: torch.Tensor
    event: Optional[torch.cuda.Event]
    requests: list
    hard_stopped: set
    n_steps: int
    audio: Optional[torch.Tensor] = None
    window: int = 0


@dataclasses.dataclass
class _PendingDetok:
    """A detokenize batch awaiting readback: its PCM (pinned host copy on
    the card), the event after the copy, the windows' (request, start,
    valid frames, window length) and the requests to test for completion
    once it resolves."""
    audio: torch.Tensor
    event: Optional[torch.cuda.Event]
    mapping: list
    finish_check: list


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
        # slot state: one row per slot plus the sentinel row (index
        # max_batch_size) that padded rows gather from and scatter to
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
        self.watermark_cfg = self.watermark_params = None
        if model.needs_watermarking:
            self.watermark_cfg = WatermarkConfig(
                style=model.watermarker_type or "silentcipher",
                sample_rate=model.sample_rate)
            self.watermark_params = init_watermarker(
                self.watermark_cfg, seeded_generator(dev, cfg.seed + 101), dev)
        if cfg.codec_dtype is not None:
            # before the cache is built and anything is captured: graphs and
            # K2's packed weights hold pointers to these tensors
            self._cast_codec(getattr(torch, cfg.codec_dtype))
        self.codec_cache = model.init_decoder_cache(rows)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(cfg.seed)

        #: LM steps awaiting host readback, oldest first
        self._pending: list[_Pending] = []
        #: detokenize batches awaiting host readback, oldest first
        self._pending_detok: list[_PendingDetok] = []
        #: step-body calls on the card outside a capture, by kind (must
        #: stay 0)
        self.eager_calls = dict.fromkeys(STEP_KINDS, 0)
        #: most LM steps / detokenize batches in flight after a dispatch;
        #: entries poll_resolved resolved; cold starts by path
        self.max_pending = 0
        self.max_pending_detok = 0
        self.polled = 0
        self.cold_starts = {"chain": 0, "two_dispatch": 0, "prefill": 0}
        self._steps = StepCache(
            dev, self._build_step, self.generator,
            max(cfg.pipeline_depth, self._detok_depth) + 2)

        def _nbytes(tree):
            return sum(a.numel() * a.element_size()
                       for a in tree_leaves(tree))

        self.logger.info(
            "device %s: params %.2fG + KV pool %.2fG + codec %.2fG (%s) + "
            "slot caches %.2fG; prefill buckets %s, decode buckets %s, table "
            "widths %s, detokenize buckets %s, KV reserve fraction %g", dev,
            _nbytes(model.params) / 2**30,
            _nbytes([self.k_pages, self.v_pages]) / 2**30,
            _nbytes(model.codec_params) / 2**30, self.codec_dtypes(),
            _nbytes(self.codec_cache) / 2**30, cfg.prefill_token_buckets,
            cfg.decode_buckets, self.table_width_buckets, cfg.detok_buckets,
            cfg.kv_reserve_fraction)
        if cfg.warmup:
            self.warmup()

    def _cast_codec(self, dtype: torch.dtype) -> None:
        """Cast every float32 leaf of the codec parameters, and of every
        codec cache the model makes from now on, to ``dtype`` (the JAX
        worker's ``codec_dtype``)."""
        model = self.model

        def cast(tree):
            return tree_map(lambda a: (a.to(dtype) if torch.is_tensor(a)
                                       and a.dtype == torch.float32 else a),
                            tree)

        model.codec_params = cast(model.codec_params)
        make_cache = model.init_decoder_cache
        model.init_decoder_cache = lambda b: cast(make_cache(b))

    def codec_dtypes(self) -> list[str]:
        """The floating dtypes of the codec's parameters and cache, read
        from the tensors."""
        return sorted({str(a.dtype).removeprefix("torch.")
                       for a in tree_leaves([self.model.codec_params,
                                             self.codec_cache])
                       if torch.is_tensor(a) and a.is_floating_point()})

    def _trace(self, name: str):
        """A ``torch.profiler`` range around a step dispatch (the JAX
        worker's trace annotations); nothing unless ``enable_profiling``."""
        if not self.config.enable_profiling:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _init_width_lattice(self) -> None:
        """Block-table limit and width lattice (the JAX worker's): the limit
        covers the largest prefill bucket plus the full generation budget,
        rounded up to whole chunks; the smallest width covers any
        first-chunk stream (largest bucket + two detokenize intervals or
        fused steps)."""
        cfg, model = self.config, self.model
        top = self.max_prefill_tokens
        width = cdiv(top + model.max_tokens + 8, cfg.page_size) + 1
        chunk_pages = max(1, CHUNK_TOKENS // cfg.page_size)
        self.max_pages_per_seq = cdiv(width, chunk_pages) * chunk_pages
        floor = cdiv(
            cdiv(top + 2 * max(model.detokenize_interval,
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
    def first_chunk_frames(self) -> int:
        if self.model.detokenize_overlap > 0:
            # overlapped-window codecs cannot ramp: a mini chunk followed by
            # a regular-window handoff would skip frames
            return 0
        f = self.config.first_chunk_frames
        return f if 0 < f < self.model.detokenize_interval else 0

    @property
    def ramp_frames(self) -> int:
        if not self.first_chunk_frames:
            return 0
        r = self.config.ramp_frames or self.model.detokenize_interval
        return max(r, self.model.detokenize_interval)

    @property
    def detokenize_overlap(self) -> int:
        return self.model.detokenize_overlap

    @property
    def supports_audio_input(self) -> bool:
        return self.model.supports_audio_input

    @property
    def max_prefill_tokens(self) -> int:
        return max(self.config.prefill_token_buckets)

    def _stat(self, name: str, t0: float) -> None:
        tot, n = self.phase_stats.get(name, (0.0, 0))
        self.phase_stats[name] = (tot + (time.perf_counter() - t0), n + 1)

    # ------------------------------------------------------------------
    # admission / release
    # ------------------------------------------------------------------
    def _gen_reserve_pages(self, prompt_len: int, max_tokens: int) -> int:
        """Pages reserved at admission: ``kv_reserve_fraction`` of the full
        generation budget (at 1.0 decode-phase page growth cannot exhaust
        the pool mid-stream)."""
        budget = max(max_tokens - prompt_len, 0) + 8
        pages = cdiv(budget, self.config.page_size) + 1
        return int(np.ceil(pages * self.config.kv_reserve_fraction))

    def can_admit(self, num_prompt_tokens: int,
                  holds_slot: bool = False) -> bool:
        """Whether a prompt can be prefilled now: a free slot (unless the
        request already holds one: a request whose prompt overflowed the
        last prefill batch keeps the slot it took) and pages for the prompt
        and its generation reserve."""
        prompt_pages = cdiv(max(num_prompt_tokens, 1), self.config.page_size)
        reserve = self._gen_reserve_pages(num_prompt_tokens,
                                          self.model.max_tokens)
        return (holds_slot or bool(self._free_slots)) and \
            self.allocator.can_reserve(prompt_pages + reserve)

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
    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device without waiting for the steps in
        flight (a pageable copy would)."""
        if self.device.type == "cuda":
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
        idx = self._upload(torch.tensor(slots, dtype=torch.long))
        tree_map(lambda a: a.index_fill_(0, idx, 0), self.codec_cache)

    def _write_slot_cache(self, slot: int, row: Any) -> None:
        """Install a request's own initial codec-cache row (a model's
        ``PreprocessOutput.decoder_cache_init``, unbatched) in its slot."""
        def put(a, r):
            t = r if torch.is_tensor(r) else torch.from_numpy(np.asarray(r))
            if t.device.type == "cpu":
                t = self._upload(t.to(a.dtype))
            a[slot].copy_(t)

        tree_map(put, self.codec_cache, row)

    # ------------------------------------------------------------------
    # readback pipelines
    # ------------------------------------------------------------------
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A step output on its way to the host: on the card a non-blocking
        copy into fresh pinned memory (the graph's output buffer is
        overwritten by its next replay); on the CPU the tensor itself."""
        if self.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _push_pending(self, sampled: torch.Tensor, requests: list[Request],
                      hard_stopped: set[int], n_steps: int,
                      audio: Optional[torch.Tensor] = None,
                      window: int = 0) -> None:
        """Queue an LM step's sampled tokens (and chained PCM) for
        readback."""
        tokens = self._to_host(sampled)
        audio = None if audio is None else self._to_host(audio)
        self._pending.append(_Pending(tokens, self._event(), list(requests),
                                      hard_stopped, n_steps, audio, window))
        self.max_pending = max(self.max_pending, len(self._pending))

    def _drain(self, depth: int) -> None:
        while len(self._pending) > depth:
            self._resolve_one()

    def _resolve_one(self) -> None:
        e = self._pending.pop(0)
        t0 = time.perf_counter()
        if e.event is not None:
            e.event.synchronize()
        # copies: the pinned buffers return to their allocator once dropped
        sampled = e.tokens.numpy().reshape(
            e.n_steps, -1, e.tokens.shape[-1]).copy()
        audio = None if e.audio is None else e.audio.numpy().copy()
        self._stat("resolve.tokens_get", t0)
        for i, req in enumerate(e.requests):
            if i in e.hard_stopped:
                # never fed this step (hard stop or KV backpressure), so no
                # inflight increment happened: no decrement either
                continue
            req.extras["inflight"] = max(
                req.extras.get("inflight", e.n_steps) - e.n_steps, 0)
            for s in range(e.n_steps):
                if req.done_lm_generation:
                    break  # steps issued past the stop point are discarded
                self.model.update_request_state(req, sampled[s, i])
            if audio is not None:
                self._emit_cold_chunk(req, audio[i], e.window)

    def _emit_cold_chunk(self, req: Request, pcm: np.ndarray,
                         window: int) -> None:
        """Emit the chained first-chunk audio (frames 0..window-1) with the
        reference trim rule for early stops, and advance the ramp as the
        mini path (``_run_detok_windows``) would.

        Different on purpose from the JAX worker, which always writes the
        ramp position here: a stream whose ramp position is already at or
        past the window (the scheduler graduated it while the chain was in
        flight) keeps its position instead of re-entering the mini ramp."""
        valid = min(len(req.lm_output_audio_tokens), window)
        if valid < window:
            trim = int(pcm.shape[1] * (valid - 0.5) / window)
            pcm = pcm[:, :max(trim, 0)]
        if pcm.shape[1]:
            req.output_audio.put(pcm.tobytes())
        if req.extras.get("ramp_next", 0) >= window:
            return
        req.extras["ramp_next"] = window
        req.extras["ramp_size"] = min(window, self.model.detokenize_interval)

    def sync(self) -> None:
        """Resolve all in-flight LM steps (host state catches up)."""
        self._drain(0)

    def poll_resolved(self) -> list[Request]:
        """Resolve, without blocking, the in-flight LM steps and detokenize
        batches whose device work is done, oldest first (the device runs
        them in order, so the first that is not done ends each poll).
        Returns the requests whose audio resolved."""
        touched: list[Request] = []
        while self._pending:
            e = self._pending[0]
            if e.event is not None and not e.event.query():
                break
            self._resolve_one()
            self.polled += 1
            if e.audio is not None:
                touched += [r for r in e.requests if r not in touched]
        while self._pending_detok:
            e = self._pending_detok[0]
            if e.event is not None and not e.event.query():
                break
            for r in self._resolve_detok():
                if r not in touched:
                    touched.append(r)
        return touched

    # ------------------------------------------------------------------
    # step bodies (one graph per key on the card)
    # ------------------------------------------------------------------
    def _count_eager(self, kind: str) -> None:
        if self.device.type == "cuda" and not self._steps.capturing:
            self.eager_calls[kind] += 1

    def _planes(self, planes) -> tuple:
        """(features, masks) from a prefill's extra inputs, in the order
        ``_prefill_inputs`` gives them."""
        planes = list(planes)
        feat = planes.pop(0) if self.model.needs_input_features else None
        msk = planes.pop(0) if self.model.needs_input_masks else None
        return feat, msk

    def _lm_prefill(self, pack: torch.Tensor, feat, msk, T: int,
                    B: int) -> torch.Tensor:
        """Prefill B padded prompt rows over T bucket tokens: KV to the
        pages, each row's sampled tokens and state to its slot. Returns the
        sampled (B, C) tokens."""
        model = self.model
        (tokens, pos, seg, page_ids, offsets, slot_ids,
         last_idx) = self._prefill_pack_views(pack, T, B, model.n_codebooks)
        meta = AttnMetadata(True, page_ids, offsets, segment_ids=seg,
                            q_positions=pos)
        rep_rows = None
        if self.rep_cache is not None:
            # a fresh request has no history: prefill starts from zeros
            rep_rows = torch.zeros((B,) + self.rep_cache.shape[1:],
                                   dtype=self.rep_cache.dtype,
                                   device=self.device)
        out = model.lm_step(model.params, tokens, pos, feat, msk, meta,
                            self.k_pages, self.v_pages, self.generator,
                            rep_rows, last_token_idx=last_idx)
        self._commit_step(out, slot_ids.long())
        return out.sampled

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

    def _multi_decode(self, pack: torch.Tensor, K: int, B: int, W: int):
        """K single-step decodes in a row over the flat fused pack, seq_lens
        advancing on the device. Returns the (K, B, C) samples, the slot
        ids and the tokens the slots held before the first step (a cold
        stream's frame 0: the prefill's sample)."""
        (overrides, override_mask, positions, page_ids, offsets, _gen_idx0,
         seq_lens0, slot_ids, tables) = self._multi_pack_views(
             pack, K, B, self.model.n_codebooks, W)
        slots = slot_ids.long()
        init_tok = self.last_tokens[slots]
        sampled = []
        for i in range(K):
            meta = AttnMetadata(False, page_ids[i], offsets[i],
                                block_tables=tables, seq_lens=seq_lens0 + i,
                                decode_scratch=self.decode_scratch)
            sampled.append(self._lm_decode(overrides[i], override_mask[i],
                                           positions[i], meta, slots))
        return torch.stack(sampled), slots, init_tok

    def _detok_rows(self, token_ids: torch.Tensor,
                    slots: torch.Tensor) -> torch.Tensor:
        """The codec over (B, L, C) windows, each in its slot's codec-cache
        row (gathered, then scattered back in place), then the watermark
        (in float32: ``torch.fft`` takes no bf16); int16 PCM (B, channels,
        samples) on the device."""
        model = self.model
        rows = (None if self.codec_cache is None
                else tree_map(lambda a: a[slots], self.codec_cache))
        audio, new_rows = model.detokenize(model.codec_params, token_ids,
                                           rows)
        if self.watermark_cfg is not None:
            marked = apply_watermark(self.watermark_params,
                                     self.watermark_cfg, audio[:, 0].float())
            audio = marked[:, None].to(audio.dtype)
        if self.codec_cache is not None and new_rows is not None:
            def put(a, r):
                a[slots] = r.to(a.dtype)
            tree_map(put, self.codec_cache, new_rows)
        return _pcm16(audio)

    def _chained_detok(self, sampled: torch.Tensor, slots: torch.Tensor,
                       init_tok: torch.Tensor) -> torch.Tensor:
        """First-chunk PCM of a fused decode: frames = the slots' tokens
        before it (the prefill's sample) + its first K-1 samples."""
        frames = torch.cat([init_tok[:, None],
                            sampled[:-1].transpose(0, 1)], dim=1)
        return self._detok_rows(frames, slots)

    def _build_step(self, key: tuple):
        """(body, fully padded inputs) of a step key (see the module
        docstring for the kinds)."""
        cfg, model = self.config, self.model
        C = model.n_codebooks
        kind = key[0]
        if kind == "prefill":
            _, T, B = key

            def body(pack, *planes):
                self._count_eager(kind)
                return self._lm_prefill(pack, *self._planes(planes), T, B)
            return body, self._padded_prefill(T)
        if kind == "decode":
            def body(pack):
                self._count_eager(kind)
                (overrides, override_mask, _gen_idx, positions, page_ids,
                 offsets, seq_lens, slot_ids, tables) = \
                    self._decode_pack_views(pack, C)
                meta = AttnMetadata(False, page_ids, offsets,
                                    block_tables=tables.contiguous(),
                                    seq_lens=seq_lens.contiguous(),
                                    decode_scratch=self.decode_scratch)
                return self._lm_decode(overrides, override_mask, positions,
                                       meta, slot_ids.long())
            return body, (self._padded_pack(key),)
        if kind in ("decode_multi", "decode_multi_detok"):
            _, B, K, W = key

            def body(pack):
                self._count_eager(kind)
                sampled, slots, init_tok = self._multi_decode(pack, K, B, W)
                if kind == "decode_multi":
                    return sampled
                return sampled, self._chained_detok(sampled, slots, init_tok)
            return body, (self._padded_pack(key),)
        if kind == "cold_chain":
            _, T, K = key
            Bp, Bd = cfg.max_prefill_requests, self._fused_bucket(1)
            W = self.table_width_buckets[0]
            n_prefill = T * (C + 4) + 2 * Bp

            def body(pack, *planes):
                self._count_eager(kind)
                s0 = self._lm_prefill(pack[:n_prefill],
                                      *self._planes(planes), T, Bp)
                sampled, slots, init_tok = self._multi_decode(
                    pack[n_prefill:], K, Bd, W)
                pcm = self._chained_detok(sampled, slots, init_tok)
                return torch.cat([s0[None, :Bd], sampled]), pcm
            ppack, *planes = self._padded_prefill(T)
            dpack = self._padded_pack(("decode_multi", Bd, K, W))
            return body, (np.concatenate([ppack, dpack]), *planes)
        if kind == "detok":
            _, B, L = key

            def body(pack):
                self._count_eager(kind)
                token_ids, slot_ids = self._detok_pack_views(pack, B, L, C)
                return self._detok_rows(token_ids, slot_ids.long())
            pack = np.zeros((B * L * C + B,), np.int32)
            self._detok_pack_views(pack, B, L, C)[1][:] = cfg.max_batch_size
            return body, (pack,)
        raise ValueError(f"unknown step key {key}")

    # ------------------------------------------------------------------
    # prefill (one graph per token bucket on the card)
    # ------------------------------------------------------------------
    def prefill_token_bucket(self, total_tokens: int) -> int:
        for b in sorted(self.config.prefill_token_buckets):
            if total_tokens <= b:
                return b
        raise ValueError(
            f"prefill of {total_tokens} tokens exceeds the largest bucket "
            f"{self.max_prefill_tokens}")

    def run_lm_prefill(self, requests: list[Request]) -> None:
        requests = self._admit_prefills(requests)
        if not requests:
            return
        t0 = time.perf_counter()
        self._dispatch_prefill(requests, self._prefill_host_arrays(requests))
        self._stat("prefill", t0)

    def _admit_prefills(self, requests: list[Request]) -> list[Request]:
        """Slot assignment, preprocessing, bucket trim and KV-page
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
        # zero the fresh slots' codec rows first; a model's own initial
        # row (decoder_cache_init, below) then overwrites its slot's
        self._zero_slot_caches(fresh_slots)

        ready: list[Request] = []
        for req in admitted_set:
            if req.input_tokens is None:
                t0 = time.perf_counter()
                try:
                    po = model.preprocess(req.prompt, req.audio_path,
                                          **req.model_kwargs)
                    req.input_tokens = np.asarray(po.input_tokens, np.int32)
                    req.input_length = len(req.input_tokens)
                    req.input_features = po.input_features
                    req.input_masks = po.input_masks
                    if (po.decoder_cache_init is not None
                            and self.codec_cache is not None):
                        self._write_slot_cache(req.slot,
                                               po.decoder_cache_init)
                except Exception as e:  # fail only this request
                    self.fail_request(req, f"preprocess failed: {e}")
                    continue
                finally:
                    # host prompt construction, with a voice clone's
                    # speaker and codec encoders
                    self._stat("preprocess", t0)
            if req.input_length > self.max_prefill_tokens:
                self.fail_request(
                    req, f"prompt of {req.input_length} tokens exceeds the "
                    f"largest prefill bucket {self.max_prefill_tokens}")
                continue
            ready.append(req)

        # trim so the batch fits the largest bucket and the pack's rows;
        # overflow defers
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

    @staticmethod
    def _prefill_pack_views(pack, T: int, B: int, C: int):
        """Views into the prefill pack, numpy on the host or torch on the
        device (the JAX worker's ``_prefill_pack_views`` /
        ``_unpack_prefill``): tokens (T, C), positions, segment ids, page
        ids and offsets (T,), slot ids and last-token indices (B,)."""
        o = 0
        tokens = pack[o:o + T * C].reshape(T, C); o += T * C
        pos = pack[o:o + T]; o += T
        seg = pack[o:o + T]; o += T
        page_ids = pack[o:o + T]; o += T
        offsets = pack[o:o + T]; o += T
        slot_ids = pack[o:o + B]; o += B
        last_idx = pack[o:o + B]; o += B
        if o != pack.shape[0]:
            raise ValueError(f"prefill pack of {pack.shape[0]} ints, "
                             f"expected {o} for T={T} B={B} C={C}")
        return tokens, pos, seg, page_ids, offsets, slot_ids, last_idx

    def _padded_prefill(self, T: int) -> tuple[np.ndarray, ...]:
        """A fully padded prefill of bucket T (segment -1, scratch page 0 at
        offsets arange % page_size, the sentinel slot) with zero feature
        and mask planes: warm-up and probe input."""
        cfg, model = self.config, self.model
        C, B = model.n_codebooks, cfg.max_prefill_requests
        pack = np.zeros((T * (C + 4) + 2 * B,), np.int32)
        (_, _, seg, _, offsets, slot_ids,
         _) = self._prefill_pack_views(pack, T, B, C)
        seg[:] = -1
        offsets[:] = np.arange(T, dtype=np.int32) % cfg.page_size
        slot_ids[:] = cfg.max_batch_size
        planes = []
        if model.needs_input_features:
            planes.append(np.zeros((T, model.backbone_config.hidden_size),
                                   np.float32))
        if model.needs_input_masks:
            planes.append(np.zeros((T, C), bool))
        return (pack, *planes)

    def _prefill_host_arrays(self, requests: list[Request]) -> dict:
        """The admitted requests in the padded prefill bucket's host arrays
        (the JAX worker's): every int32 planning array in ONE flat pack,
        the feature and mask planes beside it."""
        C = self.model.n_codebooks
        cfg = self.config
        page_size = cfg.page_size
        T = self.prefill_token_bucket(sum(r.input_length for r in requests))
        B = cfg.max_prefill_requests
        if len(requests) > B:
            raise ValueError(f"{len(requests)} prefills exceed "
                             f"max_prefill_requests={B}")
        pack, *planes = self._padded_prefill(T)
        feat, msk = self._planes(planes)
        (tokens, pos, seg, page_ids, offsets, slot_ids,
         last_idx) = self._prefill_pack_views(pack, T, B, C)
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
        return {"T": T, "B": B, "pack": pack, "feat": feat, "msk": msk}

    @staticmethod
    def _prefill_inputs(arr: dict) -> tuple[np.ndarray, ...]:
        """A prefill's step inputs: the pack, then the planes it has."""
        return (arr["pack"], *(a for a in (arr["feat"], arr["msk"])
                               if a is not None))

    def _dispatch_prefill(self, requests: list[Request], arr: dict) -> None:
        with self._trace(f"lm_prefill_t{arr['T']}_b{len(requests)}"):
            sampled = self._steps.run(("prefill", arr["T"], arr["B"]),
                                      *self._prefill_inputs(arr))
        # the first decode reads the sampled token from the slot buffer, so
        # the host copy goes through the readback pipeline like a decode's
        for req in requests:
            req.done_lm_prefill = True
            req.extras["inflight"] = req.extras.get("inflight", 0) + 1
        self._push_pending(sampled, requests, set(), 1)
        self._drain(self.config.pipeline_depth)

    # ------------------------------------------------------------------
    # decode steps
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
        """A fully padded decode pack for ``key`` (every row on scratch page
        0, seq_len 1, the sentinel slot): warm-up and probe input."""
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
                self._plan_decode_row(req, i, overrides, override_mask,
                                      gen_idx, positions, page_ids, offsets,
                                      block_tables, seq_lens, slot_ids,
                                      hard_stopped)
            except Exception as e:
                # a poisoned request must not fail its co-batched streams;
                # its row stays a padded row
                self.fail_request(req, f"decode planning: {e}")
                hard_stopped.add(i)
        return packed, hard_stopped

    def _plan_decode_row(self, req: Request, i: int, overrides,
                         override_mask, gen_idx, positions, page_ids,
                         offsets, block_tables, seq_lens, slot_ids,
                         hard_stopped: set[int]) -> None:
        """Fill row i for one request. A request that cannot step
        (block-table limit, KV backpressure) joins hard_stopped and keeps
        its padded row; an input-streaming row that steps takes its next
        text token in the override columns."""
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
        if req.is_input_streaming:
            # after the hard-stop and backpressure checks: a row that does
            # not step must not consume a queued text token or the one-shot
            # EOS
            try:
                C = self.model.n_codebooks
                tok = np.zeros((C,), np.int32)
                self._inject_streaming_text_token(req, tok)
                ch = self.model.text_channel_index % C
                overrides[i, ch] = tok[self.model.text_channel_index]
                override_mask[i, ch] = 1
            except Exception:
                # the row is live: back to the padded-row convention (scratch
                # page, sentinel slot) before the caller's fail_request frees
                # this request's pages, which a co-batched request may then
                # take
                slot_ids[i] = self.config.max_batch_size
                page_ids[i] = 0
                offsets[i] = 0
                override_mask[i, :] = 0
                req.extras["inflight"] = inflight
                raise

    def _inject_streaming_text_token(self, req: Request,
                                     tok: np.ndarray) -> np.ndarray:
        """Write the request's next streamed text token into the model's
        text channel of ``tok``: a queued token, else the text EOS once
        after the text is complete, else pad (and the request waits for
        text until it is complete)."""
        model = self.model
        ch = model.text_channel_index
        if not req.pending_text_tokens.empty():
            tok[ch] = req.pending_text_tokens.get()
            req.waiting_for_text = False
        elif req.text_complete and not req.eos_injected:
            tok[ch] = model.text_stream_eos_token()
            req.eos_injected = True
        else:
            tok[ch] = model.text_stream_pad_token()
            if not req.text_complete:
                req.waiting_for_text = True
        return tok

    def run_lm_decode(self, requests: list[Request]) -> None:
        if not requests:
            return
        t0 = time.perf_counter()
        B = self._decode_bucket(len(requests))
        W = self._table_width(requests)
        packed, hard_stopped = self._plan_decode(requests, B, W)
        self._stat("decode.plan", t0)
        t0 = time.perf_counter()
        with self._trace(f"lm_decode_b{B}"):
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

    def can_decode_multi(self, requests: list[Request], n_steps: int,
                         first_chunk: bool = False) -> bool:
        """True iff every request can take n_steps KV tokens without
        crossing its block-table limit, the batch fits a fused bucket, and
        (under a fused-k schedule) n_steps is one of the bucket's captured
        step counts. First-chunk calls are exempt from the schedule check:
        their chained graphs are captured apart."""
        if not self.config.fused_decode_steps or n_steps < 2:
            return False
        if self._fused_bucket(len(requests)) is None:
            return False
        if (self.config.fused_k_schedule and not first_chunk
                and n_steps not in (self.fused_k_for(len(requests)),
                                    self.config.fused_decode_steps)):
            return False
        limit = self.max_pages_per_seq * self.config.page_size
        return all(r.kv_token_len + n_steps <= limit for r in requests)

    def run_lm_decode_multi(self, requests: list[Request], n_steps: int,
                            first_chunk: bool = False) -> None:
        """Run n_steps decode steps for the batch in ONE graph replay.
        Callers check ``can_decode_multi``. KV pages for all k tokens are
        allocated up front; allocator backpressure leaves a request out of
        the whole fused call (padded row). ``first_chunk`` chains the
        first-chunk detokenize into the same graph at the smallest width (a
        pre-first-chunk stream holds at most the largest prefill bucket +
        the ramp's frames, which the width floor covers)."""
        if not requests:
            return
        K = n_steps
        B = self._fused_bucket(len(requests))
        if B is None:
            raise ValueError(f"no fused bucket holds {len(requests)} rows")
        t0 = time.perf_counter()
        W = (self.table_width_buckets[0] if first_chunk
             else self._table_width(requests, K))
        pack, hard_stopped = self._plan_decode_multi(requests, K, B, W)
        self._stat("decode_multi.plan", t0)
        t0 = time.perf_counter()
        if first_chunk:
            with self._trace(f"lm_cold_start_b{B}_k{K}"):
                sampled, pcm = self._steps.run(
                    ("decode_multi_detok", B, K, W), pack)
            self._push_pending(sampled, requests, hard_stopped, K, pcm, K)
        else:
            with self._trace(f"lm_decode_multi_b{B}_k{K}"):
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
        (overrides, override_mask, positions, page_ids, offsets, gen_idx0,
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
            if req.is_input_streaming:
                # after the page allocation: a deferred row consumes no text
                ch = self.model.text_channel_index % C
                for s in range(K):
                    tok = np.zeros((C,), np.int32)
                    self._inject_streaming_text_token(req, tok)
                    overrides[s, i, ch] = tok[self.model.text_channel_index]
                    override_mask[s, i, ch] = 1
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
    # cold-start chain: prefill + fused decode + first-chunk detokenize in
    # ONE graph, no host readback in between
    # ------------------------------------------------------------------
    def _chains_enabled(self) -> bool:
        """The chained first-chunk graphs exist: fused decode, a first
        chunk of >= 2 frames, a model whose samples are audio rows."""
        return (self.config.fused_decode_steps >= 2
                and self.first_chunk_frames >= 2
                and self.model.supports_chained_detok)

    def can_cold_start(self, req: Request) -> bool:
        return (self._chains_enabled()
                and self._fused_bucket(1) is not None
                and not req.is_input_streaming)

    def run_cold_start(self, req: Request) -> None:
        """Prefill + fused k-step decode + first-chunk detokenize as ONE
        graph replay (``cold_chain``) over the prefill pack and the fused
        pack, staged as one buffer: the first PCM chunk costs one dispatch
        and one readback. A prompt beyond the smallest bucket takes the
        2-dispatch path (prefill, then ``decode_multi_detok``); KV
        backpressure or the block-table limit falls back to the plain
        prefill. Callers gate on ``can_cold_start``."""
        admitted = self._admit_prefills([req])
        if req not in admitted or req.done_all:
            return  # admission deferred or preprocess failed
        t0 = time.perf_counter()
        parr = self._prefill_host_arrays(admitted)
        K = self.first_chunk_frames
        B = self._fused_bucket(1)
        if not self.can_decode_multi([req], K, first_chunk=True):
            self._dispatch_prefill(admitted, parr)
            self.cold_starts["prefill"] += 1
            return
        if parr["T"] != min(self.config.prefill_token_buckets):
            # only the smallest bucket's chain is captured at start-up
            self._dispatch_prefill(admitted, parr)
            if self.can_decode_multi([req], K, first_chunk=True):
                self.run_lm_decode_multi([req], K, first_chunk=True)
            self.cold_starts["two_dispatch"] += 1
            return
        # prefill bookkeeping BEFORE fused planning: positions/gen_idx of
        # the k decode steps count the in-flight prefill token
        req.done_lm_prefill = True
        req.extras["inflight"] = req.extras.get("inflight", 0) + 1
        dpack, hard = self._plan_decode_multi(
            [req], K, B, self.table_width_buckets[0])
        if hard:
            # fused KV preallocation deferred: undo, take the plain path
            req.done_lm_prefill = False
            req.extras["inflight"] -= 1
            self._dispatch_prefill(admitted, parr)
            self.cold_starts["prefill"] += 1
            return
        with self._trace(f"lm_cold_chain_t{parr['T']}_k{K}"):
            sampled_all, pcm = self._steps.run(
                ("cold_chain", parr["T"], K),
                np.concatenate([parr["pack"], dpack]),
                *self._prefill_inputs(parr)[1:])
        # one entry: K+1 sampled steps (prefill + K decode steps), a
        # K-frame chunk (the prefill's sample + the first K-1 steps)
        self._push_pending(sampled_all, [req], set(), K + 1, pcm, K)
        self.cold_starts["chain"] += 1
        self._stat("cold_chain", t0)
        self._drain(self.config.pipeline_depth)

    # ------------------------------------------------------------------
    # start-up capture
    # ------------------------------------------------------------------
    def _detok_lengths(self) -> list[int]:
        """Window lengths served: the interval, multi-chunk catch-up
        windows (stateful codecs) and the ramp's mini windows F, 2F, ...
        below the interval."""
        cfg, model = self.config, self.model
        interval = model.detokenize_interval
        lengths = [interval]
        if self.codec_cache is not None:
            step = interval - model.detokenize_overlap
            lengths += [(k - 1) * step + interval
                        for k in cfg.multi_chunk_ks if k > 1]
        L = self.first_chunk_frames
        while L and L < interval:
            lengths.append(L)
            L *= 2
        return list(dict.fromkeys(lengths))

    def warmup_keys(self) -> list[tuple]:
        """Every step key, in the JAX warmup's order: prefill buckets,
        (bucket x width) single steps, (fused bucket x k x width) fused
        steps (a bucket under a k-schedule takes both its k and
        fused_decode_steps), the chained first-chunk decode and the cold
        chain, then detokenize at every (bucket within the frame budget x
        length)."""
        cfg = self.config
        keys = [("prefill", T, cfg.max_prefill_requests)
                for T in sorted(cfg.prefill_token_buckets)]
        keys += [("decode", B, W) for B in cfg.decode_buckets
                 for W in self.table_width_buckets]
        K = cfg.fused_decode_steps
        if K >= 2:
            for Bi, B in enumerate(cfg.fused_decode_buckets):
                KB = cfg.fused_k_schedule[Bi] if cfg.fused_k_schedule else K
                for k in sorted({k for k in (KB, K) if k >= 2}):
                    keys += [("decode_multi", B, k, W)
                             for W in self.table_width_buckets]
        if self._chains_enabled():
            KC = self.first_chunk_frames
            keys.append(("decode_multi_detok", cfg.fused_decode_buckets[0],
                         KC, self.table_width_buckets[0]))
            keys.append(("cold_chain", min(cfg.prefill_token_buckets), KC))
        for L in self._detok_lengths():
            cap = self._detok_cap(L)
            keys += [("detok", B, L) for B in cfg.detok_buckets if B <= cap]
        return keys

    def warmup(self) -> None:
        """Capture every graph up front with fully padded inputs (scratch
        page 0, the sentinel slot: serving state is untouched) and log each
        graph's device ms per replay. On the CPU there is nothing to
        capture: steps run eagerly."""
        if self.device.type != "cuda":
            self.logger.info("warmup: steps run eagerly on %s", self.device)
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
        """Step counters for the daemon's stats file."""
        steps = self._steps
        out = {
            "graphs": [list(k) for k in steps.steps],
            "replays": steps.replays(),
            "decode_steps": steps.decode_steps(),
            "eager_calls": dict(self.eager_calls),
            "captured": steps.captured_counts(),
            "capture_s": steps.capture_s,
            "probe_ms": {" ".join(map(str, k)): ms
                         for k, ms in steps.probe_ms.items()},
            "max_pending": self.max_pending,
            "max_pending_detok": self.max_pending_detok,
            "polled": self.polled,
            "cold_starts": dict(self.cold_starts),
            "replay_spans": {k: list(v) for k, v in steps.spans.items()},
        }
        if self.device.type == "cuda":
            out["pool_mib"] = steps.pool_bytes() / 2**20
        return out

    def reset_step_stats(self) -> None:
        """Zero the per-run counters (phase times, replays, eager calls,
        pipeline depths seen, cold starts): what a served run reports
        starts here."""
        self.phase_stats.clear()
        self._steps.reset_counts()
        self.eager_calls = dict.fromkeys(STEP_KINDS, 0)
        self.max_pending = self.max_pending_detok = self.polled = 0
        self.cold_starts = dict.fromkeys(self.cold_starts, 0)

    # ------------------------------------------------------------------
    # detokenize (one graph per (bucket, length) on the card)
    # ------------------------------------------------------------------
    @staticmethod
    def _detok_pack_views(pack, B: int, L: int, C: int):
        """Views into the detokenize pack, numpy on the host or torch on
        the device: token windows (B, L, C) and slot ids (B,)."""
        return pack[:B * L * C].reshape(B, L, C), pack[B * L * C:]

    def _detok_cap(self, length: int) -> int:
        """Widest detokenize bucket whose B * length stays inside the frame
        budget (the smallest bucket is always allowed)."""
        buckets = self.config.detok_buckets
        budget = self.config.detok_frame_budget
        if not budget:
            return buckets[-1]
        cap = buckets[0]
        for b in buckets:
            if b * length <= budget:
                cap = b
        return cap

    def _detok_bucket(self, n: int, length: int) -> int:
        cap = self._detok_cap(length)
        for b in self.config.detok_buckets:
            if n <= b and b <= cap:
                return b
        return cap  # callers chunk to the ceiling

    @property
    def _detok_depth(self) -> int:
        """In-flight detokenize batches whose audio readback is deferred:
        0 when decode is synchronous, else the configured depth (>= 1)."""
        if self.config.pipeline_depth == 0:
            return 0
        return max(1, self.config.detok_pipeline_depth)

    def run_detokenize(self, requests: list[Request]) -> list[Request]:
        """Decode the selected chunk windows (and first-chunk minis) into
        PCM on the device and emit them by the reference trim rule. The
        audio readback is pipelined when pipeline_depth > 0. Returns the
        requests whose chunks (or completion) resolved."""
        if not requests:
            return self._resolve_detok() if self._pending_detok else []
        t0 = time.perf_counter()
        try:
            return self._run_detokenize(requests)
        finally:
            self._stat("detokenize", t0)

    def _run_detokenize(self, requests: list[Request]) -> list[Request]:
        model = self.model
        interval = model.detokenize_interval
        # the scheduler marks a stream done once its last window is selected
        # and sends its completion with the stream's next audio, or at its
        # next round: resolve the batches that still hold a done stream's
        # windows first, so that the completion follows its last chunk
        pre_resolved: list[Request] = []
        while any(r.done_all and self._in_flight(r) for r in requests):
            pre_resolved += self._resolve_detok()
        # first-chunk minis: short windows grouped by ramp size (stateful
        # codec caches forbid padding mixed sizes into one batch)
        F = self.first_chunk_frames
        minis = [r for r in requests if r.extras.pop("mini_chunk", False)]
        if minis and F:
            by_size: dict[int, list[Request]] = {}
            for r in minis:
                by_size.setdefault(r.extras.get("ramp_size", F), []).append(r)
            for size, group in sorted(by_size.items()):
                pre_resolved += self._run_detok_windows(group, size)
            requests = [r for r in requests if r not in minis]
            if not requests:
                if self.config.pipeline_depth == 0:
                    pre_resolved += self._resolve_detok()
                return pre_resolved

        step = interval - model.detokenize_overlap
        by_len: dict[int, tuple[list, list]] = {}
        finish_check: list[Request] = []
        for req in requests:
            try:
                self._plan_detok_windows(req, by_len, interval, step)
            except Exception as e:
                self.fail_request(req, f"detokenize planning: {e}")
                continue
            finish_check.append(req)
        if not by_len:
            resolved = self._resolve_detok()
            self._maybe_finish(finish_check)
            return pre_resolved + resolved + finish_check

        resolved = []
        groups = sorted(by_len.items())
        for gi, (L, (wins, maps)) in enumerate(groups):
            fc = finish_check if gi == len(groups) - 1 else []
            resolved += self._issue_detok(wins, maps, L, fc)
        return pre_resolved + resolved

    def _plan_detok_windows(self, req: Request, by_len: dict, interval: int,
                            step: int) -> None:
        """Collect req's ready chunk windows into by_len (len -> windows)."""
        req.audio_decode_idx = list(req.next_audio_decode_idx)
        if self.codec_cache is not None and len(req.audio_decode_idx) > 1:
            idx = req.audio_decode_idx
            k = next((kk for kk in self.config.multi_chunk_ks
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

    def _dispatch_detok(self, windows: list, slots: list[int], length: int,
                        mapping: list, finish_check: list[Request]
                        ) -> list[Request]:
        """One detokenize replay over n <= cap windows padded to their
        bucket (padded rows: token 0, the sentinel slot); resolves the
        batches beyond the pipeline depth."""
        C = self.model.n_codebooks
        B = self._detok_bucket(len(windows), length)
        pack = np.zeros((B * length * C + B,), np.int32)
        token_ids, slot_ids = self._detok_pack_views(pack, B, length, C)
        slot_ids[:] = self.config.max_batch_size
        for i, (w, s) in enumerate(zip(windows, slots)):
            token_ids[i] = w
            slot_ids[i] = s
        t0 = time.perf_counter()
        with self._trace(f"detokenize_b{B}_l{length}"):
            pcm = self._steps.run(("detok", B, length), pack)
        self._pending_detok.append(_PendingDetok(
            self._to_host(pcm), self._event(), mapping, finish_check))
        self.max_pending_detok = max(self.max_pending_detok,
                                     len(self._pending_detok))
        self._stat("detok.dispatch", t0)
        resolved: list[Request] = []
        t0 = time.perf_counter()
        while len(self._pending_detok) > self._detok_depth:
            resolved += self._resolve_detok()
        self._stat("detok.resolve", t0)
        return resolved

    def _issue_detok(self, windows: list, mapping: list, length: int,
                     finish_check: list[Request]) -> list[Request]:
        """Issue one detokenize batch of fixed-length windows. Batches wider
        than the length's bucket cap split into cap-sized batches."""
        cap = self._detok_cap(length)
        if len(windows) > cap:
            resolved = []
            for s in range(0, len(windows), cap):
                fc = finish_check if s + cap >= len(windows) else []
                resolved += self._issue_detok(windows[s:s + cap],
                                              mapping[s:s + cap], length, fc)
            return resolved
        tot, cnt = self.phase_stats.get("detok.windows", (0.0, 0))
        self.phase_stats["detok.windows"] = (tot + len(windows), cnt + 1)
        return self._dispatch_detok(windows, [m[0].slot for m in mapping],
                                    length, mapping, finish_check)

    def _run_detok_windows(self, requests: list[Request], length: int
                           ) -> list[Request]:
        """Issue a detokenize batch of `length`-frame windows starting at
        each request's ramp position (first-chunk ramp minis tile [0,
        ramp_frames) contiguously before regular windows take over).
        Returns requests resolved by displacing a pending batch."""
        model = self.model
        requests = requests[: self.config.max_batch_size]
        cap = self._detok_cap(length)
        if len(requests) > cap:
            resolved = []
            for s in range(0, len(requests), cap):
                resolved += self._run_detok_windows(requests[s:s + cap],
                                                    length)
            return resolved
        step = model.detokenize_interval - model.detokenize_overlap
        windows, mapping = [], []
        for req in requests:
            start = req.extras.get("ramp_next", 0)
            windows.append(np.stack(
                req.lm_output_audio_tokens[start:start + length], axis=0))
            mapping.append((req, start, length, length))
            req.extras["ramp_next"] = start + length
            # the next mini decodes as many frames as are already banked
            # as playback (cap: interval): sizes F, F, 2F, ...
            req.extras["ramp_size"] = min(req.extras["ramp_next"],
                                          model.detokenize_interval)
            if req.extras["ramp_next"] >= self.ramp_frames:
                # ramp complete: regular windows continue from here
                req.audio_decode_idx = [req.extras["ramp_next"] - step]
                req.next_audio_decode_idx = [req.extras["ramp_next"] - step]
        return self._dispatch_detok(windows, [r.slot for r in requests],
                                    length, mapping, [])

    def _resolve_detok(self) -> list[Request]:
        if not self._pending_detok:
            return []
        e = self._pending_detok.pop(0)
        t0 = time.perf_counter()
        if e.event is not None:
            e.event.synchronize()
        audio = e.audio.numpy()  # (B, channels, samples) int16
        self._stat("detok.audio_get", t0)
        touched: list[Request] = []
        for i, (req, _start, last_len, window_len) in enumerate(e.mapping):
            pcm = audio[i]
            # overlap codecs emit only the first (window - overlap) frames'
            # audio, so the final-partial trim counts in the emitted span
            step_len = window_len - self.model.detokenize_overlap
            if last_len < step_len:
                trim = int(pcm.shape[1] * (last_len - 0.5) / step_len)
                pcm = pcm[:, :max(trim, 0)]
            req.output_audio.put(pcm.tobytes())
            if req not in touched:
                touched.append(req)
        self._maybe_finish(e.finish_check)
        for r in e.finish_check:
            if r not in touched:
                touched.append(r)
        return touched

    def flush_detokenize(self) -> list[Request]:
        """Resolve every in-flight detokenize batch."""
        out: list[Request] = []
        while self._pending_detok:
            out += self._resolve_detok()
        return out

    def _in_flight(self, req: Request) -> bool:
        """Whether a detokenize batch in flight holds one of req's
        windows."""
        return any(m[0] is req for e in self._pending_detok
                   for m in e.mapping)

    def _maybe_finish(self, requests: list[Request]) -> None:
        """Mark done the requests whose last window has been decoded.
        Different on purpose from the JAX worker, which also finishes a
        request whose last window is still in a batch in flight (its window
        list already names that window when the batch before resolves), so
        the completion went out ahead of the last chunk: here the batch
        that holds the last window finishes it. (A stream the scheduler
        marks done itself has its windows resolved first, in
        ``_run_detokenize``.)"""
        interval = self.model.detokenize_interval
        for req in requests:
            if self._in_flight(req):
                continue
            if req.done_lm_generation and req.audio_decode_idx and (
                    req.audio_decode_idx[-1] + interval
                    >= len(req.lm_output_audio_tokens)):
                req.done_all = True
            elif req.done_lm_generation and not req.lm_output_audio_tokens:
                req.done_all = True
