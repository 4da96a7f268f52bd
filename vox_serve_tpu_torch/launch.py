"""CLI entry of the port: ``python -m vox_serve_tpu_torch.launch``.

Serves the HTTP API of vox_serve_tpu (the port's copy of its aiohttp app,
``server/app.py`` ``build_app``) in front of the port's scheduler daemon,
one per data-parallel rank. Every flag of a serving profile left unset
(batch, pages, page size, the bucket lattices, pipelines, fused decode,
codec dtype, KV reserve) is filled from the model's profile in
``profiles.py``, measured on one H100, as the JAX launcher does with its
own; explicit flags win.

    python -m vox_serve_tpu_torch.launch --model qwen3-tts
    python -m vox_serve_tpu_torch.launch --model qwen3-tts --kv-quant int8
    python -m vox_serve_tpu_torch.launch --model dummy --device cpu
    python -m vox_serve_tpu_torch.launch --model qwen3-tts \
        --fused-decode-steps 4 --fused-decode-buckets 1,4 --pipeline-depth 2
    python -m vox_serve_tpu_torch.launch --model qwen3-tts \
        --first-chunk-frames 3 --fused-decode-steps 4 \
        --fused-decode-buckets 1,4 --pipeline-depth 2 \
        --detok-pipeline-depth 2
    python -m vox_serve_tpu_torch.launch --model qwen3-tts \
        --scheduler-type input_streaming --codec-dtype bfloat16 \
        --kv-reserve-fraction 0.5

``--dp-size N`` serves N replicas, one daemon per card (``cuda:<rank>``,
pinned with ``CUDA_VISIBLE_DEVICES``), requests assigned round robin.
``--tp-size N`` splits each replica's backbone and KV pool over N cards
(tensor parallelism, one process per card; replica r on cards r*N ..
r*N+N-1). ``--enable-disaggregation`` (or ``--scheduler-type
disaggregation``) runs
the LM on ``cuda:0`` and the detokenizer on ``cuda:1`` in one daemon; it
excludes ``--dp-size > 1`` (exit 2). On ``--device cuda`` the launcher
refuses to serve, and stops the daemons, when the machine has fewer cards
than that asks for.

The JAX package's environment switches apply as there: ``VOX_KV_COMBINED=0``
serves the legacy head-major KV pair, ``VOX_FUSED_RESUNIT=1`` the codec's
fused residual-unit stacks. A model given by its published id loads its
checkpoint from the Hugging Face hub cache (``HF_HUB_CACHE``, see
``weights.py``).

The scheduler daemons are spawned before the launcher imports torch, so
their start-up (torch, CUDA, the model, the graph capture) overlaps the
launcher's own checks of the device and the model name; a failed check
stops them and exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile

from .utils import get_logger, set_global_log_level

logger = get_logger("launch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="vox_serve_tpu_torch API server")
    p.add_argument("--model", default="dummy")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails at start-up without CUDA) or "
                        "cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scheduler-type", default="online",
                   choices=["base", "online", "offline", "input_streaming",
                            "disaggregation"])
    p.add_argument("--async-scheduling", action="store_true",
                   help="overlap host scheduling with the device: decode "
                        "readback pipelined at depth 2 unless "
                        "--pipeline-depth is set")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    # None = from the model's serving profile (profiles.py), else the
    # generic default there
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--max-num-pages", type=int, default=None)
    p.add_argument("--page-size", type=int, default=None)
    p.add_argument("--prefill-buckets", default=None,
                   help="comma list of prefill token buckets (default "
                        "128,1024)")
    p.add_argument("--max-prefill-requests", type=int, default=None,
                   help="rows of one prefill (default 8)")
    p.add_argument("--kv-quant", default=None,
                   choices=["none", "f8_e4m3", "int8"],
                   help="quantized KV pool storage (halves KV bytes; f8_e4m3 "
                        "needs no calibration, int8 uses --kv-k-amax/"
                        "--kv-v-amax)")
    p.add_argument("--kv-k-amax", type=float, default=None,
                   help="int8 KV: expected |K| absmax (scale = amax/127)")
    p.add_argument("--kv-v-amax", type=float, default=None,
                   help="int8 KV: expected |V| absmax (scale = amax/127)")
    p.add_argument("--weight-quant", default=None,
                   choices=["none", "int8"],
                   help="int8 weight-only quantization of the backbone "
                        "matmuls (halves decode weight streaming; for "
                        "weight-bound families like Orpheus-3B)")
    p.add_argument("--no-warmup", action="store_true",
                   help="capture each decode graph at its first use, not "
                        "at start-up")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="in-flight decode steps with deferred readback")
    p.add_argument("--detok-pipeline-depth", type=int, default=None,
                   help="in-flight detokenize batches with deferred audio "
                        "readback (default 1; 0 when --pipeline-depth is 0)")
    p.add_argument("--first-chunk-frames", type=int, default=None,
                   help="emit a stream's first chunk after N frames (TTFA)")
    p.add_argument("--ramp-frames", type=int, default=None,
                   help="extend the mini-chunk ramp to N frames before "
                        "regular detokenize windows (0: one interval)")
    p.add_argument("--detok-buckets", default=None,
                   help="comma list overriding the detokenize-batch "
                        "lattice (last may be below max-batch-size)")
    p.add_argument("--detok-frame-budget", type=int, default=None,
                   help="cap on batch*length frames per detokenize graph "
                        "(0 disables)")
    p.add_argument("--fused-decode-steps", type=int, default=None,
                   help="run N decode steps per graph replay (0 disables)")
    p.add_argument("--fused-decode-buckets", default=None,
                   help="comma list of batch buckets served by the fused "
                        "k-step decode graphs (include max-batch-size to "
                        "fuse the full decode batch)")
    p.add_argument("--fused-k-schedule", default=None,
                   help="comma list: fused step count per fused-decode "
                        "bucket (values <= fused-decode-steps)")
    p.add_argument("--fused-min-batch", type=int, default=None,
                   help="latency/throughput regime boundary: decode batches "
                        "below N run single-step rounds, at/above N fused "
                        "rounds (0: always fuse when eligible)")
    p.add_argument("--decode-buckets", default=None,
                   help="comma list overriding the decode-batch lattice")
    p.add_argument("--table-width-buckets", default=None,
                   help="comma list of block-table width buckets (pages); "
                        "each step runs at the smallest bucket covering "
                        "the batch")
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
    p.add_argument("--kv-reserve-fraction", type=float, default=None,
                   help="fraction of the worst-case generation budget "
                        "reserved at admission (1.0 = never defer; <1 "
                        "overcommits for concurrency)")
    p.add_argument("--enable-profiling", action="store_true",
                   help="record each scheduler round, step dispatch and "
                        "blocking wait on the card as a span; the daemon "
                        "writes them with its --stats-file as "
                        "STATS_FILE.spans.json (Chrome trace events)")
    p.add_argument("--dp-size", type=int, default=1,
                   help="data-parallel replicas, one card each")
    p.add_argument("--tp-size", type=int, default=1,
                   help="tensor-parallel cards per replica (the backbone "
                        "and its KV pool split over them)")
    p.add_argument("--enable-disaggregation", action="store_true",
                   help="LM on cuda:0, detokenizer on cuda:1 (one daemon)")
    p.add_argument("--stats-file", default=None,
                   help="scheduler daemon writes kernel launch counts and "
                        "phase times here when it is terminated")
    p.add_argument("--socket-suffix", default="")
    p.add_argument("--log-level", default="info")
    p.add_argument("--timeout-seconds", type=float, default=600.0)
    return p


def cards_missing(args, count: int) -> str | None:
    """Why ``count`` cards cannot serve ``args`` on the card (None: they
    can): ``tp_size`` cards per data-parallel rank, two for
    disaggregation."""
    if args.device.startswith("cuda"):
        need = (2 if args.enable_disaggregation
                else args.dp_size * args.tp_size)
        if count < need:
            # the flags that ask for the cards
            what = ("--enable-disaggregation" if args.enable_disaggregation
                    else " ".join(f"--{k}-size {n}" for k, n in (
                        ("dp", args.dp_size), ("tp", args.tp_size))
                        if n > 1) or "--dp-size 1")
            return (f"{what} needs {need} CUDA cards; this machine has "
                    f"{count}")
    return None


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    set_global_log_level(args.log_level)

    # coerce before the exclusion check, as the JAX launcher does
    if args.scheduler_type == "disaggregation":
        args.enable_disaggregation = True
    if args.dp_size > 1 and args.enable_disaggregation:
        logger.error("--dp-size > 1 and --enable-disaggregation are mutually "
                     "exclusive")
        sys.exit(2)
    # fill the unset flags from the model's serving profile
    from .profiles import apply_profile
    apply_profile(args, logger)

    from aiohttp import web
    from .server.api import APIServer
    from .server.app import build_app

    scheduler_args = {
        "device": args.device,
        "seed": args.seed,
        "max_num_pages": args.max_num_pages,
        "page_size": args.page_size,
        "prefill_buckets": args.prefill_buckets,
        "max_prefill_requests": args.max_prefill_requests,
        "kv_quant": args.kv_quant,
        "kv_k_amax": args.kv_k_amax,
        "kv_v_amax": args.kv_v_amax,
        "weight_quant": args.weight_quant,
        "no_warmup": args.no_warmup,
        "pipeline_depth": args.pipeline_depth,
        "detok_pipeline_depth": args.detok_pipeline_depth,
        "first_chunk_frames": args.first_chunk_frames,
        "ramp_frames": args.ramp_frames,
        "detok_buckets": args.detok_buckets,
        "detok_frame_budget": args.detok_frame_budget,
        "fused_decode_steps": args.fused_decode_steps,
        "fused_decode_buckets": args.fused_decode_buckets,
        "fused_k_schedule": args.fused_k_schedule,
        "fused_min_batch": args.fused_min_batch,
        "decode_buckets": args.decode_buckets,
        "table_width_buckets": args.table_width_buckets,
        "top_p": args.top_p, "top_k": args.top_k, "min_p": args.min_p,
        "temperature": args.temperature, "max_tokens": args.max_tokens,
        "repetition_penalty": args.repetition_penalty,
        "repetition_window": args.repetition_window,
        "cfg_scale": args.cfg_scale, "greedy": args.greedy,
        "async_scheduling": args.async_scheduling,
        "detokenize_interval": args.detokenize_interval,
        "codec_dtype": args.codec_dtype,
        "kv_reserve_fraction": args.kv_reserve_fraction,
        "enable_profiling": args.enable_profiling,
        "enable_disaggregation": args.enable_disaggregation,
        "tp_size": args.tp_size,
        "stats_file": args.stats_file,
        "log_level": args.log_level,
    }
    tmp = tempfile.gettempdir()
    server = APIServer(
        model_name=args.model,
        scheduler_type=args.scheduler_type,
        output_dir=os.path.join(tmp, "vox_serve_audio"),
        upload_dir=os.path.join(tmp, "vox_serve_uploads"),
        max_batch_size=args.max_batch_size,
        dp_size=args.dp_size,
        socket_suffix=args.socket_suffix,
        timeout_seconds=args.timeout_seconds,
        scheduler_args=scheduler_args,
    )
    try:
        from .models import get_model_class, resolve_device

        resolve_device(args.device)  # no CUDA: stop the daemons, fail
        cls = get_model_class(args.model)  # validates the name
        if args.device.startswith("cuda"):
            import torch

            missing = cards_missing(args, torch.cuda.device_count())
            if missing:
                raise SystemExit(missing)
    except BaseException:
        server.cleanup()
        raise
    if args.async_scheduling and (args.pipeline_depth or 0) >= 2:
        logger.warning(
            "--async-scheduling: decode readback is already pipelined "
            "(pipeline_depth=%d); the flag adds nothing here. It only has "
            "an effect with --pipeline-depth 0/1.", args.pipeline_depth)
    sample_rate = getattr(cls, "SAMPLE_RATE", None) or 24000

    def _shutdown(signum, frame):
        logger.info("received signal %s, shutting down", signum)
        server.cleanup()
        os._exit(0)

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)

    app = build_app(server, sample_rate=sample_rate)
    logger.info("serving %s on %s:%d (%s)", args.model, args.host, args.port,
                args.device)
    web.run_app(app, host=args.host, port=args.port, print=None)


if __name__ == "__main__":
    main()
