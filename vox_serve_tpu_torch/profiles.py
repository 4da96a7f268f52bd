"""Per-model serving profiles of the port: the configuration measured on
one H100, applied by ``launch.py`` to the flags left unset (port of
vox_serve_tpu/profiles.py, with the port's own values).

Each value of ``SERVING_PROFILES`` comes from
``scripts/torch_profile_sweep.py`` (its module docstring states the rules)
on an H100 80GB HBM3 at 700 W, by the rule its comment names; a key a
profile does not list keeps the generic value. ``PERF.md`` §6 holds the
measurements. Explicit CLI flags always win over the profile.

Two differences from the JAX module, on purpose:

* no ``enable_pallas``: on the card the port always runs its kernels, and
  the port has no ``--enable-pallas`` / ``--disable-pallas``;
* ``fused_min_batch`` is batch-scaled: under an explicit
  ``--max-batch-size`` other than the profile's it is dropped with the
  lattices. The JAX module keeps it, so a profile's regime boundary can
  lie above the requested batch and fused rounds never run.
"""

from __future__ import annotations

from typing import Any

#: generic fallbacks for models without a profile: the port's CLI and
#: daemon defaults (not a measurement)
DEFAULT_PROFILE: dict[str, Any] = {
    "max_batch_size": 8,
    "max_num_pages": 2048,
    "page_size": 16,
    "pipeline_depth": 0,
    "first_chunk_frames": 0,
    "ramp_frames": 0,
    "fused_decode_steps": 0,
    "fused_decode_buckets": None,
    "fused_k_schedule": None,
    "fused_min_batch": None,
    "detok_pipeline_depth": 1,
    "codec_dtype": None,
    "decode_buckets": None,
    "detok_buckets": None,
    "prefill_buckets": None,
    "max_prefill_requests": None,
    "kv_reserve_fraction": None,
    "table_width_buckets": None,
}

#: substring of the model name -> its profile over the defaults
SERVING_PROFILES: dict[str, dict[str, Any]] = {
    # Qwen3-TTS-1.7B (random weights, published widths; a decode step with
    # its 15-codebook depth loop 32.8 ms at B=128 over 1,087 tokens of
    # context; a round's 13 ready windows through the bf16 codec 17.7 ms):
    # - batch: the largest B whose decode + detokenize device time per
    #   round gives every stream 1.5x real time (12.5 frames/s): 128 at
    #   19.8 frames/s each (144: 17.2);
    # - pages: 90% of the 74.2 GB free once every graph of this lattice is
    #   captured, over 1,835,008 bytes a page (280 streams at max_tokens);
    # - decode buckets: a smaller batch joins when its step costs at most
    #   0.75 of the smallest bucket in (16: 23.9 ms vs 32.8; 1 always);
    # - detokenize buckets: the same rule from the round's 13 windows down
    #   (10: 12.9 ms, 5: 9.6, 2: 5.4, 1: 4.3; the decode lattice would pad
    #   a round's windows to 16 or 128);
    # - codec: bf16 detokenizes 26 windows in 33.5 ms against f32's 62.3;
    # - pipeline depth 0 (generic): depth 2 took 27.69 ms a frame against
    #   29.01, above 0.95 of it; fused decode off (generic): k=4 took 27.79
    #   ms a frame against single steps' 27.69;
    # - prefill buckets: the 0.75 rule over 21.4 (T=64) ... 27.6 ms
    #   (T=1024) keeps the smallest and the largest.
    "qwen3": {
        "max_batch_size": 128,
        "max_num_pages": 36450,
        "decode_buckets": "1,16,128",
        "detok_buckets": "1,2,5,10,13",
        "codec_dtype": "bfloat16",
        "pipeline_depth": 0,
        "fused_decode_steps": 0,
        "prefill_buckets": "64,1024",
    },
    # CSM-1B (its 31-codebook depth step 41.1 ms at B=256; a round's 26
    # windows through bf16 Mimi 7.1 ms): every B to 256 gives 1.5x real
    # time (20.8 frames/s at 256); pages from 76.5 GB free at 524,288
    # bytes a page; decode buckets by the 0.75 rule (64: 30.4 ms),
    # detokenize buckets by it from 26 windows (15: 5.0, 7: 3.8, 2: 2.7, 1:
    # 2.2 ms); bf16 codec (7.1 vs 10.2 ms at 26 windows); pipeline depth 2
    # (37.60 vs 40.68 ms a frame at B=256); fused decode off (38.05 vs
    # 37.60 ms a frame).
    "csm": {
        "max_batch_size": 256,
        "max_num_pages": 131464,
        "decode_buckets": "1,64,256",
        "detok_buckets": "1,2,7,15,26",
        "codec_dtype": "bfloat16",
        "pipeline_depth": 2,
        "fused_decode_steps": 0,
        "prefill_buckets": "64,1024",
    },
    # Orpheus-3B (decode 6.6 ms at B=8, 7.7 at 16; SNAC bf16 1.3 ms for a
    # round's 2 windows): a stream needs 82.03 tokens/s in real time (7
    # tokens a 2,048-sample window at 24 kHz), 1.5x of it up to B=8 (126.4
    # tokens/s; 16: 108.9); pages from 74.5 GB free at 1,835,008 bytes;
    # detokenize buckets 1 and 2 (a round's ceil(8 / 7) windows); bf16
    # codec (8.67 vs 10.20 ms at 28 windows); pipeline depth 2 (7.21 vs
    # 7.69 ms a token at B=8); fused decode off (7.19 vs 7.21, above 0.95
    # of it); prefill buckets by the 0.75 rule over 7.3 (T=64) ... 16.3 ms
    # (T=1024).
    "orpheus": {
        "max_batch_size": 8,
        "max_num_pages": 36588,
        "decode_buckets": "1,8",
        "detok_buckets": "1,2",
        "codec_dtype": "bfloat16",
        "pipeline_depth": 2,
        "fused_decode_steps": 0,
        "prefill_buckets": "64,128,512,1024",
    },
    # the CPU model of the tests: small everything (not measured)
    "dummy": {
        "max_batch_size": 8,
        "max_num_pages": 256,
        "page_size": 8,
    },
}


def resolve_profile(model_name: str) -> dict[str, Any]:
    """Profile for a model name (first substring match), over the generic
    defaults."""
    prof = dict(DEFAULT_PROFILE)
    low = (model_name or "").lower()
    for key, overrides in SERVING_PROFILES.items():
        if key in low:
            prof.update(overrides)
            break
    return prof


#: profile entries scaled to the profile's max_batch_size; under another
#: explicit --max-batch-size they are left unset, so that the worker
#: derives them for the requested batch (its bucket checks would refuse
#: the profile's lattices, and a regime boundary above the batch would
#: never be reached)
_BATCH_SCALED_KEYS = ("decode_buckets", "detok_buckets",
                      "fused_decode_buckets", "fused_k_schedule",
                      "fused_min_batch")


def apply_profile(args, logger=None) -> dict[str, Any]:
    """Fill unset (None) argparse flags from the model's serving profile;
    returns what it filled with a value other than the generic one."""
    prof = resolve_profile(args.model)
    user_batch = getattr(args, "max_batch_size", None) is not None
    # --max-batch-size equal to the profile's own batch keeps the tuned
    # lattices
    conflicting_batch = (user_batch
                         and args.max_batch_size != prof.get("max_batch_size"))
    # explicit --decode-buckets without --max-batch-size: the buckets'
    # last entry is the batch (the profile's batch would break the worker's
    # buckets[-1] == max_batch_size rule)
    user_decode_buckets = getattr(args, "decode_buckets", None)
    if user_decode_buckets and not user_batch:
        args.max_batch_size = int(str(user_decode_buckets).split(",")[-1])
        conflicting_batch = (
            args.max_batch_size != prof.get("max_batch_size"))
        if logger is not None:
            logger.info("--decode-buckets implies --max-batch-size %d",
                        args.max_batch_size)
    applied = {}
    for key, value in prof.items():
        if conflicting_batch and key in _BATCH_SCALED_KEYS:
            continue
        if getattr(args, key, None) is None:
            setattr(args, key, value)
            if value != DEFAULT_PROFILE.get(key):
                applied[key] = value
    if applied and logger is not None:
        logger.info("serving profile for %r: %s (explicit flags override)",
                    args.model,
                    " ".join(f"{k}={v}" for k, v in sorted(applied.items())))
    return applied
