#!/usr/bin/env python3
"""Split one decode step of a model of the PyTorch port (GLM-4-Voice-9B,
Step-Audio-2-mini, Zonos-v0.1 with its 9 codebooks, or Orpheus-3B) into
its parts on the card: the embedding gather, the backbone (K1 over a bf16
pool; with ``--weight-quant int8`` its matmuls through K5 over packed
int8 weights, 4 launches a layer, as the worker serves them), the head(s) and the sampler (with the
model's repetition penalty where it has one), each captured in a CUDA
graph and timed by its replays, beside the whole step (``lm_step``, with
Zonos's delay mask at ``gen_idx``) and each part's bound (the bytes it
must move over 3.35 TB/s: at int8 the backbone's bytes are its int8
weights and float32 scales).

    PYTHONPATH=. python3 scripts/torch_decode_split.py [--model glm]
        [--batch 4] [--context 1000] [--weight-quant int8]

Random weights at the published widths (seed 0); every row attends to
``--context`` tokens of a random KV pool. Needs one card (~1 min with the
kernels' build).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

import chip_smoke as c
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.backbone import (backbone_forward,
                                                 pack_backbone_params,
                                                 quantize_backbone_params,
                                                 w8a16_groups)
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.ops.attention import AttnMetadata
from vox_serve_tpu_torch.sampling import (init_repetition_cache,
                                          sample_and_update)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="glm",
                    choices=("glm", "step-audio-2", "zonos", "orpheus"))
    ap.add_argument("--weight-quant", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--batch", type=int, default=4)
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
    m = get_model_class(args.model)(device=dev, seed=0)
    cfg = m.backbone_config
    scratch = None
    if args.weight_quant == "int8":  # as the worker's weight_quant="int8"
        m.params = dict(m.params)
        m.params["backbone"] = pack_backbone_params(quantize_backbone_params(
            m.params["backbone"]))
        torch.cuda.empty_cache()
        scratch = kernels.W8A16Scratch(dev, w8a16_groups(m.params["backbone"]))
    B, n, page = args.batch, args.context, 16
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
    x = m.embed(m.params, ids, None, None)
    h = torch.randn((B, cfg.hidden_size), device=dev, dtype=torch.bfloat16)
    logits = m.logits(m.params, h)
    # the tables whose rows are gathered (one per codebook) and the heads
    embed_key = "embeds" if "embeds" in m.params else "embed"
    head_key = "heads" if "heads" in m.params else "head"
    head = m.params[head_key]
    filt = (f"top-p {sc.top_p}" if sc.top_p is not None
            else f"min-p {sc.min_p}")
    parts = {
        "embed": (lambda: m.embed(m.params, ids, None, None),
                  (C + 1) * B * cfg.hidden_size * 2),
        f"backbone ({L} layers, K1"
        f"{' + K5 int8' if scratch is not None else ''})": (
            lambda: backbone_forward(m.params["backbone"], cfg, x, pos, meta,
                                     pool),
            sum(t.numel() * t.element_size() for t in
                _leaves(m.params["backbone"]))
            + 2 * B * n * L * KH * D * 2),
        f"head ({logits.dtype})": (
            lambda: m.logits(m.params, h),
            head.numel() * head.element_size()
            + logits.numel() * logits.element_size()),
        f"sample ({filt}, T {sc.temperature}, repetition "
        f"{sc.repetition_penalty}, {C} codebook(s))": (
            lambda: sample_and_update(logits, sc, gen, rep),
            logits.numel() * logits.element_size() + B * C * 4),
        "lm_step (all of it)": (
            lambda: m.lm_step(m.params, ids, pos, None, None, meta, pool,
                              None, gen, rep, gen_idx=gen_idx),
            sum(t.numel() * t.element_size() for t in _leaves(m.params))
            - m.params[embed_key].numel() * 2 + 2 * B * n * L * KH * D * 2),
    }
    for name, (fn, nbytes) in parts.items():
        ms = c.cuda_time_ms(fn, graph=True)
        bound = nbytes / c.HBM_BYTES_PER_S * 1e3
        print(f"{args.model} decode B={B} context={n} weight_quant="
              f"{args.weight_quant}: {name}: {ms:.3f} "
              f"ms, bound "
              f"{bound:.3f} ms (bytes {nbytes / 1e9:.3f} GB), share "
              f"{bound / ms:.2f}")


def _leaves(tree):
    from vox_serve_tpu_torch.params import tree_leaves

    return tree_leaves(tree)


if __name__ == "__main__":
    main()
