#!/usr/bin/env python3
"""Split one decode step of a model of the PyTorch port (GLM-4-Voice-9B,
Step-Audio-2-mini, Zonos-v0.1 with its 9 codebooks, Orpheus-3B, or the two
with a depth loop, Qwen3-TTS-12Hz-1.7B and CSM-1B) into its parts on the
card: the embedding gather, the backbone (the talker: K1 over a bf16 pool;
with ``--weight-quant int8`` its matmuls through K5 over packed int8
weights, 4 launches a layer, as the worker serves them), the head(s) with
the sampler (with the model's repetition penalty where it has one), and
for Qwen3-TTS and CSM the depth loop (``post_sample``: the codebooks after
the first, one depth forward each, K6 around the projections), each
captured in a CUDA graph and timed by its replays, beside the whole step
(``lm_step``, with Zonos's delay mask at ``gen_idx``). Each part prints its
bound (the bytes it must move over 3.35 TB/s: at int8 the backbone's bytes
are its int8 weights and float32 scales; the depth loop's, its stack's
weights once per forward) and the kernels one call of it launches (as the
profiler records an eager call: what its graph capture holds).

    PYTHONPATH=. python3 scripts/torch_decode_split.py [--model glm]
        [--batch 4[,16,...]] [--context 1000] [--weight-quant int8]

Random weights at the published widths (seed 0); every row attends to
``--context`` tokens of a random KV pool. ``--batch`` takes a list; Qwen3
and CSM default to 1,16,128 (their decode buckets). Needs one card (~1 min
with the kernels' build; Qwen3 and CSM a few minutes at three batches).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

import chip_smoke as c
from vox_serve_tpu_torch.models import BaseLMWithDepth, get_model_class
from vox_serve_tpu_torch.models.backbone import (backbone_forward,
                                                 pack_backbone_params,
                                                 quantize_backbone_params,
                                                 w8a16_groups)
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.ops.attention import AttnMetadata
from vox_serve_tpu_torch.sampling import (init_repetition_cache,
                                          sample_and_update)

#: ``--model`` -> the registry's name
MODELS = {"glm": "glm", "step-audio-2": "step-audio-2", "zonos": "zonos",
          "orpheus": "orpheus", "qwen3": "qwen3-tts", "csm": "csm"}
#: the depth-loop models' decode buckets (their launch profiles)
DEPTH_BATCHES = "1,16,128"


def launches(fn) -> int:
    """The kernels, copies and fills one eager call of ``fn`` puts on the
    card, from a profiler trace of it (0 where the profiler records no
    device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="glm", choices=tuple(MODELS))
    ap.add_argument("--weight-quant", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--batch", default=None,
                    help=f"rows, comma-separated (default 4; Qwen3 and CSM "
                         f"{DEPTH_BATCHES})")
    ap.add_argument("--context", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    kernels.build()
    dev = torch.device("cuda")
    m = get_model_class(MODELS[args.model])(device=dev, seed=0)
    batches = args.batch or (DEPTH_BATCHES if isinstance(m, BaseLMWithDepth)
                             else "4")
    scratch = None
    if args.weight_quant == "int8":  # as the worker's weight_quant="int8"
        m.params = dict(m.params)
        m.params["backbone"] = pack_backbone_params(quantize_backbone_params(
            m.params["backbone"]))
        torch.cuda.empty_cache()
        scratch = kernels.W8A16Scratch(dev, w8a16_groups(m.params["backbone"]))
    for B in (int(b) for b in batches.split(",")):
        split(args, m, dev, B, scratch)
        torch.cuda.empty_cache()


def split(args, m, dev, B: int, scratch) -> None:
    cfg = m.backbone_config
    n, page = args.context, 16
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    maxp = -(-n // page)
    pool = torch.randn((L, B * maxp + 1, page, 2 * KH, D), device=dev,
                       dtype=torch.bfloat16)
    tables = (torch.arange(B * maxp, device=dev, dtype=torch.int32)
              .reshape(B, maxp) + 1)
    seq = torch.full((B,), n, dtype=torch.int32, device=dev)
    meta = AttnMetadata(
        False, tables[:, (n - 1) // page].contiguous(),
        torch.full((B,), (n - 1) % page, dtype=torch.int32, device=dev),
        block_tables=tables, seq_lens=seq,
        decode_scratch=kernels.DecodeScratch(dev, B, cfg.num_heads, KH, D,
                                             maxp),
        linear_scratch=scratch)
    C = m.n_codebooks
    ids = torch.randint(0, cfg.vocab_size, (B, C), device=dev,
                        dtype=torch.int32)
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    gen_idx = torch.full((B,), 20, dtype=torch.int32, device=dev)
    gen = None  # the default CUDA generator: graph capture tracks it
    sc = m.sampling_config
    rep = (init_repetition_cache(B, sc.cache_window, C, cfg.vocab_size, dev)
           if m.use_repetition_penalty else None)
    # the depth models' decode feeds back the last frame's codebook sum
    feats = (torch.zeros((B, m.feedback_dim), device=dev, dtype=m.dtype)
             if m.feedback_dim else None)
    x = m.embed(m.params, ids, feats, None)
    h = torch.randn((B, cfg.hidden_size), device=dev, dtype=torch.bfloat16)
    logits = m.adjust_logits(m.logits(m.params, h))
    cb = torch.zeros((B, logits.shape[1]), device=dev, dtype=torch.int32)
    # the tables only rows of which are read, and the heads
    tables = [m.params[k] for k in ("embeds", "embed", "text_embedding",
                                    "codec_embedding", "audio_embed",
                                    "text_embed") if k in m.params]
    head_key = next(k for k in ("heads", "head", "codec_head", "lm_head")
                    if k in m.params)
    head = m.params[head_key]
    filt = (f"top-p {sc.top_p}" if sc.top_p is not None
            else f"min-p {sc.min_p}" if sc.min_p is not None
            else f"top-k {sc.top_k}")
    sampling = ("greedy" if sc.is_greedy else
                f"{filt}, T {sc.temperature}")
    parts = {
        "embed": (lambda: m.embed(m.params, ids, feats, None),
                  (C + 1) * B * cfg.hidden_size * 2),
        f"backbone ({L} layers, K1"
        f"{' + K5 int8' if scratch is not None else ''})": (
            lambda: backbone_forward(m.params["backbone"], cfg, x, pos, meta,
                                     pool),
            _bytes(m.params["backbone"]) + 2 * B * n * L * KH * D * 2),
        f"head + sample ({logits.dtype}; {sampling}, repetition "
        f"{sc.repetition_penalty}, {logits.shape[1]} codebook(s))": (
            lambda: sample_and_update(
                m.adjust_logits(m.logits(m.params, h)), sc, gen, rep),
            head.numel() * head.element_size()
            + 2 * logits.numel() * logits.element_size()),
    }
    step_bytes = _bytes(m.params) - _bytes(tables)
    if isinstance(m, BaseLMWithDepth):
        # a forward per codebook after the first (C counts a text column
        # too) reads the stack's weights; the heads and the projection are
        # read once a frame, the depth tables by row
        fwd, d = C - 2, m.params["depth"]
        loop = ((fwd - 1) * _bytes(d["backbone"]) + _bytes(d)
                - _bytes(d["embeds"]))
        step_bytes += loop - _bytes(d)
        parts[f"depth loop ({m.depth_config.num_layers} layers x {fwd} "
              f"forwards)"] = (lambda: m.post_sample(m.params, h, cb, gen),
                               loop)
    parts["lm_step (all of it)"] = (
        lambda: m.lm_step(m.params, ids, pos, feats, None, meta, pool, None,
                          gen, rep, gen_idx=gen_idx),
        step_bytes + 2 * B * n * L * KH * D * 2)
    for name, (fn, nbytes) in parts.items():
        ms = c.cuda_time_ms(fn, graph=True)
        n_launch = launches(fn)
        bound = nbytes / c.HBM_BYTES_PER_S * 1e3
        print(f"{args.model} decode B={B} context={n} weight_quant="
              f"{args.weight_quant}: {name}: {ms:.3f} ms, "
              f"{n_launch if n_launch else 'not measured'} launches, bound "
              f"{bound:.3f} ms (bytes {nbytes / 1e9:.3f} GB), share "
              f"{bound / ms:.2f}", flush=True)


def _bytes(tree) -> int:
    from vox_serve_tpu_torch.params import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


if __name__ == "__main__":
    main()
