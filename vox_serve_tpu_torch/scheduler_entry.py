"""Scheduler daemon subprocess entry:
``python -m vox_serve_tpu_torch.scheduler_entry`` (port of
vox_serve_tpu/scheduler_entry.py).

Builds the model on ``--device`` (default ``cuda``; asking for CUDA where
it is unavailable fails at start-up), the port's synchronous worker and a
scheduler, and runs the scheduler loop. On the card the CUDA kernels are
built before the daemon reports ready, so no request pays for ``nvcc``.

The worker flags are the JAX daemon's: ``--no-warmup`` (capture each
graph at its first use instead of at start-up), ``--prefill-buckets``,
``--max-prefill-requests``, ``--pipeline-depth``,
``--detok-pipeline-depth``, ``--first-chunk-frames``, ``--ramp-frames``,
``--fused-decode-steps``, ``--fused-decode-buckets``, ``--fused-k-schedule``,
``--fused-min-batch``, ``--decode-buckets``, ``--table-width-buckets``,
``--detok-buckets``, ``--detok-frame-budget``, ``--codec-dtype``,
``--kv-reserve-fraction`` and ``--enable-profiling``; ``--cfg-scale``
overlays the model's sampling defaults, and ``--async-scheduling`` maps to
decode pipelining at depth 2 when ``--pipeline-depth`` is 0, as there.

``--stats-file PATH``: the daemon zeroes the kernel launch counters and the
worker's step counters just before its loop starts and, when it is
terminated, writes the counts, the worker's per-phase wall times, its
step counters (graphs captured, replays per kind, the first and last
ordinal of each kind's replays, decode steps taken, eager step calls on
the card per kind, the kernel counts one replay of each graph adds,
capture seconds, each graph's device ms per replay from the start-up
probe, the deepest readback pipelines seen, cold starts by path, the
graph pool's size), the last completed requests' prompt lengths,
audio-token counts and finish reasons, and the configuration it served
(model, scheduler type, KV layout and pool dtype, whether the codec ran
the fused residual-unit stacks, the codec's tensor dtypes as read from
its parameters and cache, the watermark it applied ("spectral",
"silentcipher" or null), which of the model's parts came from a
checkpoint and which from random init (``checkpoint``: talker or
backbone, codec, codec encoder, speaker encoder) and whether the
tokenizer did (``tokenizer_loaded``), the KV reserve fraction, the
fused-decode, pipeline, first-chunk and bucket settings) there as JSON: how a caller that drives the daemon over
HTTP learns which kernels the served requests ran, and that no option fell
back silently.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from .utils import get_logger, set_global_log_level


def _run_scheduler_daemon(args) -> None:
    import faulthandler

    faulthandler.enable()
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    logger = get_logger("scheduler_entry")
    logger.info("scheduler daemon starting (rank %d, model %s, device %s)",
                args.rank, args.model, args.device)

    from .models import load_model
    from .ops import kernels
    from .ops.resunit import (fused_resunit_stack, fused_resunit_stack_bf16,
                              use_fused_resunit)
    from .scheduler import load_scheduler
    from .watermark import watermark_kind
    from .worker import ModelWorker, WorkerConfig

    model = load_model(
        args.model, device=args.device, seed=args.seed,
        top_p=args.top_p, top_k=args.top_k, min_p=args.min_p,
        temperature=args.temperature, max_tokens=args.max_tokens,
        repetition_penalty=args.repetition_penalty,
        repetition_window=args.repetition_window, cfg_scale=args.cfg_scale,
        greedy=args.greedy, detokenize_interval=args.detokenize_interval,
    )
    # --async-scheduling (the reference's overlapped batch selection) maps
    # to decode pipelining, as in the JAX daemon: the graph replays already
    # run ahead of the host, and pipeline_depth defers the sampled-token
    # readback
    pipeline_depth = args.pipeline_depth
    if args.async_scheduling and pipeline_depth == 0:
        pipeline_depth = 2
    wcfg = WorkerConfig(
        max_batch_size=args.max_batch_size,
        num_pages=args.max_num_pages,
        page_size=args.page_size,
        max_prefill_requests=args.max_prefill_requests,
        seed=args.seed,
        warmup=not args.no_warmup,
        pipeline_depth=pipeline_depth,
        detok_pipeline_depth=args.detok_pipeline_depth,
        first_chunk_frames=args.first_chunk_frames,
        ramp_frames=args.ramp_frames,
        fused_decode_steps=args.fused_decode_steps,
        fused_decode_buckets=(
            _parse_buckets(args.fused_decode_buckets) or (1,)),
        fused_k_schedule=_parse_buckets(args.fused_k_schedule) or None,
        fused_min_batch=args.fused_min_batch or None,
        decode_buckets_override=_parse_buckets(args.decode_buckets),
        table_width_buckets=_parse_buckets(args.table_width_buckets),
        detok_buckets_override=_parse_buckets(args.detok_buckets),
        codec_dtype=args.codec_dtype,
        enable_profiling=args.enable_profiling,
        **({"kv_reserve_fraction": args.kv_reserve_fraction}
           if args.kv_reserve_fraction is not None else {}),
        **({"detok_frame_budget": args.detok_frame_budget}
           if args.detok_frame_budget is not None else {}),
        **({"prefill_token_buckets": _parse_buckets(args.prefill_buckets)}
           if args.prefill_buckets else {}),
        **({"kv_quant": args.kv_quant}
           if args.kv_quant is not None else {}),
        **({"kv_k_amax": args.kv_k_amax}
           if args.kv_k_amax is not None else {}),
        **({"kv_v_amax": args.kv_v_amax}
           if args.kv_v_amax is not None else {}),
    )
    worker = ModelWorker(model, wcfg)
    if model.device.type == "cuda":
        kernels.build()
    scheduler = load_scheduler(
        args.scheduler_type,
        model_worker=worker,
        max_batch_size=args.max_batch_size,
        rank=args.rank,
        socket_suffix=args.socket_suffix,
        async_scheduling=args.async_scheduling,
    )
    if args.stats_file:
        from .params import tree_leaves

        def _count(tree):
            return sum(a.numel() for a in tree_leaves(tree))

        param_count = {"lm": _count(model.params),
                       "codec": _count(model.codec_params)}
        served = {
            "model": args.model,
            "scheduler_type": args.scheduler_type,
            "kv_layout": "combined" if worker.kv_config.combined else "pair",
            "kv_pool_dtype": str(worker.k_pages.dtype).removeprefix("torch."),
            "kv_scales": worker.kv_config.kv_scales,
            "fused_resunit": use_fused_resunit(),
            "codec_dtypes": worker.codec_dtypes(),
            "watermark": watermark_kind(worker.watermark_params),
            "checkpoint": dict(model.checkpoint_parts),
            "tokenizer_loaded": bool(getattr(model, "assets_available",
                                             False)),
            "kv_reserve_fraction": wcfg.kv_reserve_fraction,
            "async_scheduling": args.async_scheduling,
            "fused_decode_steps": wcfg.fused_decode_steps,
            "fused_decode_buckets": list(wcfg.fused_decode_buckets),
            "pipeline_depth": wcfg.pipeline_depth,
            "detok_pipeline_depth": wcfg.detok_pipeline_depth,
            "first_chunk_frames": worker.first_chunk_frames,
            "prefill_token_buckets": list(wcfg.prefill_token_buckets),
            "detok_buckets": list(wcfg.detok_buckets),
        }
        kernels.reset_launch_counts()
        worker.reset_step_stats()

        def _dump(signum, frame):
            with open(args.stats_file, "w") as f:
                json.dump({"launches": kernels.launch_counts(),
                           "resunit_stacks": fused_resunit_stack.stacks,
                           "resunit_bf16_stacks":
                               fused_resunit_stack_bf16.stacks,
                           "phase_stats": worker.phase_stats,
                           "steps": worker.step_stats(),
                           "requests": list(scheduler.completed),
                           "param_count": param_count, **served}, f)
            os._exit(0)

        signal.signal(signal.SIGTERM, _dump)
    scheduler.run_forever()


def _parse_buckets(spec):
    if not spec:
        return None
    return tuple(int(x) for x in str(spec).split(",") if x)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="vox_serve_tpu_torch scheduler "
                                            "daemon")
    p.add_argument("--model", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scheduler-type", default="online",
                   choices=["base", "online", "offline", "input_streaming"])
    p.add_argument("--async-scheduling", action="store_true")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--prefill-buckets", default=None,
                   help="comma list of prefill token buckets")
    p.add_argument("--max-prefill-requests", type=int, default=8)
    p.add_argument("--kv-quant", default=None,
                   choices=["none", "f8_e4m3", "int8"],
                   help="quantized KV pool storage")
    p.add_argument("--kv-k-amax", type=float, default=None)
    p.add_argument("--kv-v-amax", type=float, default=None)
    p.add_argument("--socket-suffix", default="")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--pipeline-depth", type=int, default=0)
    p.add_argument("--detok-pipeline-depth", type=int, default=1,
                   help="in-flight detokenize batches with deferred audio "
                        "readback")
    p.add_argument("--first-chunk-frames", type=int, default=0)
    p.add_argument("--ramp-frames", type=int, default=0)
    p.add_argument("--detok-buckets", default=None,
                   help="comma list overriding the detokenize-batch lattice "
                        "(last entry may be below max-batch-size: wider "
                        "batches split)")
    p.add_argument("--detok-frame-budget", type=int, default=None,
                   help="cap on batch*length frames per detokenize graph "
                        "(0 disables)")
    p.add_argument("--fused-decode-steps", type=int, default=0)
    p.add_argument("--fused-k-schedule", default="")
    p.add_argument("--fused-min-batch", type=int, default=0)
    p.add_argument("--fused-decode-buckets", default=None,
                   help="comma list of batch buckets served by the fused "
                        "k-step decode graphs (include max-batch-size "
                        "to fuse the full decode batch)")
    p.add_argument("--decode-buckets", default=None,
                   help="comma list overriding the decode-batch lattice")
    p.add_argument("--table-width-buckets", default=None,
                   help="comma list of block-table width buckets (pages)")
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--repetition-window", type=int, default=None)
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--detokenize-interval", type=int, default=None)
    p.add_argument("--codec-dtype", default=None,
                   help="serve the audio codec at this dtype (bfloat16)")
    p.add_argument("--kv-reserve-fraction", type=float, default=None)
    p.add_argument("--enable-profiling", action="store_true")
    p.add_argument("--stats-file", default=None,
                   help="write kernel launch counts and phase times here "
                        "as JSON when terminated")
    p.add_argument("--log-level", default="info")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    set_global_log_level(args.log_level)
    try:
        _run_scheduler_daemon(args)
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
