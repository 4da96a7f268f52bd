#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vox_serve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build: compiles the port's CUDA kernels (csrc/*.cu, sm_90a) with nvcc,
   one process per source, in parallel.
3. paged decode attention at Qwen3-TTS-1.7B talker shapes (B in {1, 4, 8,
   64}, H=16, KH=8, D=128, page 16, 28 layers, 4096 pages so pool offsets
   pass 2^31), random non-contiguous block tables, seq_lens up to ~1000
   (40-120 at B=4, the served batch) and one padded row; each kernel
   against its plain PyTorch version on the same inputs, with CUDA-event
   times of both: K1 over the combined bf16 pool, K1q over int8 and float8
   e4m3 pools (same scales on both sides), K4 over the head-major bf16 pair.
   Then K1 at Orpheus-3B's heads (H=24, KH=8: a GQA group of 3) at B=4 and
   64, at a group of 7 (H=28, KH=4: 4 + 3 heads per CTA) at B=4, and at
   CSM-1B's (H=32, KH=8, head dim 64: a group of 4) at B=4 and 64.
4. K3 ragged prefill attention vs its plain version at T in {64, 168, 256,
   1024} with 1-5 ragged segments (T=168: four 42-token prompts, the served
   prefill; valid rows compared); CUDA-event times of K3, its plain version
   and its library yardstick (one ``scaled_dot_product_attention`` call
   with the block-diagonal causal mask; the port never calls it). Then K3
   at G = 3 (T=168 and 1024), G = 7 (T=1024) and CSM's G = 4 at head dim
   64 (T=168 and 1024).
   Every kernel line also gives its bound: the larger of its bytes over
   3.35 TB/s and its operations over the H100's peak for the inputs' type.
   Then a small-width talker backbone (prefill + 3 decode steps over the
   paged pool) on the card through the kernels, against the same weights
   on the CPU in float32 through the plain versions, for the combined bf16,
   int8 and float8 pools and the pair layout, and once each at a GQA group
   of 3 (Orpheus) and of 4 at head dim 64 (CSM), with Llama-3.1 rope
   scaling.
   Then K2, the codec's residual-unit stack, against its plain version at
   the four decoder-block shapes of a detokenize of 4 streams x 10 frames
   and of one stream (B=4 and B=1), whole and as two streamed chunks with
   caches, with CUDA-event times and TFLOP/s per block and summed: in
   float32 (3xTF32) and in bf16 (the codec served at ``--codec-dtype
   bfloat16``; against the bf16 plain version, the Pallas kernel's
   rounding points).
   Then CSM's codec path at full width: the Mimi decoder (random weights
   from a seed) for 4 streams x 10 frames, whole and as two streamed
   chunks with caches, on the card against the CPU in float32 and in bf16
   against float32; the spectral watermark over a 19,200-sample chunk per
   stream and SilentCipher's encode (random params, one chunk at 44.1
   kHz), card vs CPU; CUDA-event times of each.
5. end to end over HTTP: ``python -m vox_serve_tpu_torch.launch --model
   qwen3-tts --device cuda`` serves Qwen3-TTS-12Hz-1.7B-CustomVoice at full
   width (28x2048 talker, 5x1024 depth, default codec; random weights from a
   seed) under eight configurations in turn: A (default: K1, K3), B
   (``--kv-quant int8`` with ``VOX_FUSED_RESUNIT=1``: K1q, K3, K2), C
   (``--kv-quant f8_e4m3``: K1q, K3), D (``VOX_KV_COMBINED=0``: K4, K3), E
   (A with ``--fused-decode-steps 4 --fused-decode-buckets 1,4
   --pipeline-depth 2``: fused k-step decode graphs, pipelined readback
   and ``poll_resolved``) and F (A with ``--first-chunk-frames 3
   --fused-decode-steps 4 --fused-decode-buckets 1,4 --pipeline-depth 2
   --detok-pipeline-depth 2``: the cold-start chain, the first-chunk ramp's
   mini detokenize windows, detokenize two deep), G (A with ``--codec-dtype
   bfloat16 --scheduler-type input_streaming --kv-reserve-fraction 0.05``
   and ``VOX_FUSED_RESUNIT=1``: K1, K3 and K2 in bf16; two of its four
   streams send their text in three pieces ~150 ms apart through
   /generate/stream/start, /text, /end and read /audio) and H (A with
   ``--scheduler-type offline --codec-dtype bfloat16``: the unfused bf16
   codec; every detokenize replay must come after the last LM step). Run I
   serves ``--model orpheus`` (Orpheus-3B: 28 x 3072 Llama-3.2-3B, 24 heads
   over 8 KV heads, vocab 156,940, Llama-3.1 rope; the float32 SNAC 24 kHz
   decoder; random weights from the seed) with ``--max-tokens 160``: K1 and
   K3 at G = 3, single-step decode graphs, detokenize graphs over
   overlapped 28-token windows every 7 tokens, no first-chunk ramp; each
   stream's PCM must be exactly what the overlap trim rule gives for the
   audio tokens its daemon reports (``requests`` in the stats file), at
   least 6 windows; it prints TTFA, windows/s against real time (11.72 per
   stream) and the decode and detokenize replay times. In every other run
   each stream's PCM is exactly what the trim rule gives for the frames its
   daemon reports (with F's and K's ramp: whole, or half a frame short).
   Runs J and K serve
   ``--model csm`` (CSM-1B: a 16 x 2048 Llama-3.2-1B backbone, 32 heads
   over 8 KV heads at head dim 64, a 4 x 1024 depth decoder sampling 31
   codebooks per step, the Mimi codec with its transformer ring in the slot
   cache, the spectral watermark in every detokenize graph; random
   weights from the seed) with ``--max-tokens 100``: J with default flags,
   K with ``--codec-dtype bfloat16 --first-chunk-frames 3
   --fused-decode-steps 4 --fused-decode-buckets 1,4 --pipeline-depth 2
   --detok-pipeline-depth 2`` (no cold chain: CSM's rows do not chain).
   The daemon must report the spectral watermark; K1 and K3 launch 16
   times per decode step and per prefill replay; each stream's PCM is
   what the trim rule gives for the audio tokens its daemon reports (with
   K's ramp, whole or half a frame short); each prints frames/s per stream
   against real time (12.5).
   Every prefill, decode
   step, detokenize, chained first-chunk decode and cold chain of every
   run is a replay of a CUDA graph captured at the daemon's start-up. Each
   run serves 4 concurrent streaming /generate requests that must return
   non-empty PCM16; F first serves one stream alone (the scheduler then
   takes the cold chain) and prints its TTFA beside A's median. The
   scheduler daemon zeroes its counters before its loop starts and writes
   them, with the configuration it served, when terminated: each run must
   show its model, KV layout, pool dtype, codec path, watermark and decode
   settings, launch
   its kernels and none of the others, replay prefill, decode and
   detokenize graphs and call no step body eagerly, launch K3 28 times per
   prefill or cold-chain replay and its decode kernel 28 times per decode
   step taken (a fused, chained or cold-chain replay takes k steps), and
   launch every kernel exactly as often as its graphs' replays times what
   their captures counted (B and G: K2's stacks too; the codec's tensors
   are read back as bf16 in G and H). E must replay fused graphs
   and hold two steps in flight, and is compared with A (within 20% of A's
   frames/s, a miss printed, not fatal); F must replay a cold chain and
   3- and 6-frame detokenize graphs and hold two detokenize batches in
   flight. Each run prints its decode step's and detokenize's wall time,
   each graph's device ms per replay from the start-up probe, the capture
   time and graph pool size, TTFA and aggregate frames/s; G prints its text
   streams' TTFA (first piece to first PCM byte) beside its /generate
   streams'.

6. checkpoints in the published layouts (``synthetic_checkpoints.py``):
   random weights from seeds at the published widths and tensor names,
   written with the port's safetensors writer (or ``torch.save`` where the
   published repo ships ``.bin`` / ``.ckpt`` files) into a temporary
   Hugging Face hub cache, one family at a time, each resolved by its id
   through ``HF_HUB_CACHE`` and loaded onto the card by the package's
   loaders, every tensor held bit-equal to the one written, with the bytes,
   seconds, GB/s and the peak resident set of each load printed:
   Qwen/Qwen3-TTS-12Hz-1.7B-Base (talker, depth and ``speaker_encoder.*``,
   bf16), Qwen/Qwen3-TTS-Tokenizer-12Hz (the decoder and the 32-codebook
   ``encoder.*`` Mimi model, float32), sesame/csm-1b (with
   ``codec_model.*`` and two 0.96 s prompt WAVs),
   canopylabs/orpheus-3b-0.1-ft at full width but 4 of its 28 layers,
   hubertsiuzdak/snac_24khz (``pytorch_model.bin``, weight-norm pairs) and
   sony/silentcipher (its three state dicts and ``hparams.yaml``, at the
   512-row band of phase 4). Between them it serves, each daemon resolving
   its model by id in that cache: run L, ``--model
   Qwen/Qwen3-TTS-12Hz-1.7B-Base --max-tokens 200``, four streams: two ICL
   voice clones (a 3 s 24 kHz reference WAV uploaded as the ``audio``
   field, and a ``ref_text``), one ``x_vector_only_mode=true`` clone and
   one without audio; run M, ``--model
   Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign --max-tokens 140`` from the same
   talker without a speaker encoder, two ``instruct`` streams; run N, J's
   configuration from the sesame/csm-1b snapshot (``--max-tokens 1072``:
   every prompt carries the default two-speaker context built from the
   prompt WAVs through the Mimi encoder on the card). Each must report
   every part of its model loaded from the checkpoint (a mapping that fell
   back to random init fails the run), K1 and K3 launched in graphs as in
   A, each stream's PCM by the trim rule, and each prompt exactly as long
   as its variant's rows (L's ICL prompts hold the reference's 38 frames,
   M's have no speaker row, N's the context).

The line before the last is a JSON object describing each kernel (at its
largest shape); the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels-only

runs phases 1-4's attention-kernel checks only and prints no result lines.
The script builds and times the port beside it, so a copy of it placed in
another checkout (a parent commit unpacked with ``git archive``) times
that checkout's kernels at this script's shapes.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "smoke_out"  # server log and stats (gitignored)

K1_TOL = 2e-2  # bf16 output rounding (2^-8 relative) + f32 sum order
K3_TOL = 2e-2
# relative to max |ref|: f32 sums over 7*C + C products in another order,
# each product in 3xTF32 (hi*hi + hi*lo + lo*hi, ~2^-21 relative), and sinf
# against torch's sin
K2_REL_TOL = 1e-4
# K2 in bf16 against its bf16 plain version, relative to max |ref|: both
# round y, z and the output to bf16 at the same points, so another f32 sum
# order flips a rounding by one bf16 step (2^-7 of the top binade), and a
# flip carried through the chained units can add one more: 2^-6
K2_BF16_REL_TOL = 2.0 ** -6
# bf16 weights/activations vs the f32 CPU run (quantized pools: the two
# runs quantize K/V computed in bf16 and in f32, so a few elements round
# to a neighbouring int8 / float8 value)
BACKBONE_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, graph: bool = False) -> float:
    """Mean ms per call of ``iters`` back-to-back calls between two CUDA
    events. Eager calls include the host's cost per call wherever the host
    is slower than the device; ``graph=True`` captures the calls in one CUDA
    graph and times its replay, which is the device's time alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    run, reps = fn, iters
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, reps = g.replay, 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_times(plain, kernel, iters: int = 20,
                    graph: bool = False) -> tuple[float, float]:
    """plain, kernel, kernel, plain; mean of the two runs of each."""
    p1 = cuda_time_ms(plain, iters, graph)
    k1 = cuda_time_ms(kernel, iters, graph)
    k2 = cuda_time_ms(kernel, iters, graph)
    p2 = cuda_time_ms(plain, iters, graph)
    return (k1 + k2) / 2, (p1 + p2) / 2


# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W): the least time the
# card could take for a kernel's work is the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the peak rate for the type they run in (tensor cores:
# bf16, 8-bit, TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "8bit": 1979e12, "tf32": 495e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and what bounds it (bytes or operations)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def result(err: float, ms: float, plain_ms: float, bnd: dict,
           library_ms=None) -> dict:
    """One kernel's entry of the result line (at one shape)."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "bound_share": bnd["bound_ms"] / ms, "library_ms": library_ms}


def bound_text(r: dict) -> str:
    lib = r["library_ms"]
    return (f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bound_share="
            f"{r['bound_share']:.3f} library_ms="
            f"{'none' if lib is None else format(lib, '.4f')}")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------


#: decode variants: name -> (pool element type, layout)
DECODE_VARIANTS = {
    "K1": ("bfloat16", "combined"),
    "K1q int8": ("int8", "combined"),
    "K1q f8_e4m3": ("float8_e4m3fn", "combined"),
    "K4": ("bfloat16", "pair"),
}


#: the (seq_lens, block tables) of each decode batch size and the segment
#: lengths of each K3 length, as first drawn: later checks (other pools,
#: other head layouts) reuse them, so each reads the same KV tokens
_DECODE_ROWS: dict = {}
_K3_LENS: dict = {}


def check_decode(kernels, variant: str, H: int = 16, KH: int = 8,
                 batches=(1, 4, 8, 64), D: int = 128) -> dict:
    """One paged decode kernel against its plain version at a talker's
    shapes (Qwen3's H=16/KH=8 by default; Orpheus's H=24/KH=8, G = 3;
    CSM's H=32/KH=8 at D=64, G = 4), reading the last layer of a 4096-page
    pool. Returns the last batch's result."""
    import torch

    dev = torch.device("cuda")
    dtype_name, layout = DECODE_VARIANTS[variant]
    dtype = getattr(torch, dtype_name)
    L, P, page = 28, 4096, 16
    layer = L - 1  # the far end of the pool: offsets past 2^31 elements
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    kv_scales = None
    if layout == "pair":
        shape = (L, KH, P, page, D)
        pools = [torch.empty(shape, dtype=dtype, device=dev) for _ in "kv"]
        for pl in pools:
            pl[layer].normal_(generator=g)
    else:
        pool = torch.empty((L, P, page, 2 * KH, D), dtype=dtype, device=dev)
        if dtype == torch.int8:
            pool[layer] = torch.randint(-127, 128, pool.shape[1:],
                                        generator=g, device=dev,
                                        dtype=torch.int8)
            kv_scales = (4.0 / 127.0, 4.0 / 127.0)
        elif dtype == torch.float8_e4m3fn:
            pool[layer] = torch.randn(pool.shape[1:], generator=g,
                                      device=dev).to(dtype)
            kv_scales = (1.0, 1.0)
        else:
            pool[layer].normal_(generator=g)
        pools = [pool]
    elem = torch.empty((), dtype=dtype).element_size()
    # the split workspace for every shape below, as a worker holds one
    scratch = kernels.DecodeScratch(dev, 64, H, KH, D, -(-1000 // page))
    if layout == "pair":
        def kernel(q, tables, seq):
            return kernels.paged_decode_attention_pair(q, *pools, layer,
                                                       tables, seq,
                                                       scratch=scratch)

        def plain(q, tables, seq):
            return kernels.paged_decode_attention_pair_plain(
                q, *pools, layer, tables, seq)
    else:
        def kernel(q, tables, seq):
            return kernels.paged_decode_attention(q, pools[0], layer, tables,
                                                  seq, kv_scales=kv_scales,
                                                  scratch=scratch)

        def plain(q, tables, seq):
            return kernels.paged_decode_attention_plain(
                q, pools[0], layer, tables, seq, kv_scales=kv_scales)

    worst, res = 0.0, {}
    rng = torch.Generator().manual_seed(2)
    for B in batches:
        if B not in _DECODE_ROWS:
            if B == 4:  # the served batch: 42-token prompts, <= 100 frames
                seq = torch.randint(40, 121, (B,), generator=rng)
            else:
                seq = torch.randint(1, 1001, (B,), generator=rng)
            if B > 1:
                seq[B // 2] = 1  # padded row: seq_len 1 on scratch page 0
            maxp = int((seq.max() + page - 1) // page)
            perm = torch.randperm(P - 1, generator=rng)[: B * maxp] + 1
            tables = perm.reshape(B, maxp).to(torch.int32)
            if B > 1:
                tables[B // 2] = 0
            _DECODE_ROWS[B] = (seq, tables)
        seq, tables = (t.clone() for t in _DECODE_ROWS[B])
        q = torch.randn((B, H, D), generator=rng).to(torch.bfloat16)
        q, tables, seq = q.to(dev), tables.to(dev), seq.to(torch.int32).to(dev)
        out = kernel(q, tables, seq)
        ref = plain(q, tables, seq)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > K1_TOL:
            raise AssertionError(f"{variant} B={B}: max_abs_err {err} > "
                                 f"{K1_TOL}")
        ms, plain_ms = alternate_times(lambda: plain(q, tables, seq),
                                       lambda: kernel(q, tables, seq),
                                       graph=True)
        eager_ms = cuda_time_ms(lambda: kernel(q, tables, seq))
        worst = max(worst, err)
        # bytes the kernel must move: every live token's K and V rows, q,
        # out, the block tables and lengths; 2 flops per K and V element
        # per query head
        tokens = int(seq.sum())
        kv_bytes = tokens * 2 * KH * D * elem
        nbytes = kv_bytes + 2 * B * H * D * 2 + tables.numel() * 4 + B * 4
        bnd = bound(nbytes, 4.0 * tokens * H * D,
                    "bf16" if elem == 2 else "8bit")
        r = result(worst, ms, plain_ms, bnd)
        log(f"{variant} {layout} {dtype_name} pool H={H} KH={KH} D={D} B={B} "
            f"max_seq={int(seq.max())} tokens={tokens} "
            f"max_abs_err={err:.3e} (tol {K1_TOL}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} eager_call_ms={eager_ms:.4f} "
            f"kv_read_GB/s="
            f"{kv_bytes / (ms * 1e-3) / 1e9:.0f} ({elem} B/elem) "
            f"{bound_text(r)}")
        res = r
    del pools
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: K3 and the small backbone
# ---------------------------------------------------------------------------


def check_k3(kernels, H: int = 16, KH: int = 8,
             shapes=((64, 1), (168, 4), (256, 3), (1024, 5)),
             D: int = 128) -> dict:
    """K3 against its plain version and SDPA at (T, segments) shapes, for
    Qwen3's H=16/KH=8 by default (Orpheus: H=24/KH=8; CSM: H=32/KH=8 at
    D=64). Returns the last shape's result."""
    import torch

    dev = torch.device("cuda")
    rng = torch.Generator().manual_seed(3)
    worst, res = 0.0, {}
    for T, nseg in shapes:
        if T == 168:  # the served prefill: four 42-token prompts
            lens = [42] * 4
        elif T in _K3_LENS:
            lens = _K3_LENS[T]
        else:
            # nseg random positive spans, then a padded tail (seg -1)
            valid = T - int(torch.randint(0, T // 8 + 1, (1,),
                                          generator=rng))
            cuts = sorted((torch.randperm(valid - 1, generator=rng)
                           [: nseg - 1] + 1).tolist())
            lens = [b - a for a, b in zip([0] + cuts, cuts + [valid])]
        _K3_LENS[T] = lens
        seg = torch.full((T,), -1, dtype=torch.int32)
        c = 0
        for i, n in enumerate(lens):
            seg[c:c + n] = i
            c += n
        q = torch.randn((T, H, D), generator=rng).to(torch.bfloat16).to(dev)
        k = torch.randn((T, KH, D), generator=rng).to(torch.bfloat16).to(dev)
        v = torch.randn((T, KH, D), generator=rng).to(torch.bfloat16).to(dev)
        seg = seg.to(dev)
        out = kernels.ragged_prefill_attention(q, k, v, seg)
        ref = kernels.ragged_prefill_attention_plain(q, k, v, seg)
        torch.cuda.synchronize()
        valid = seg >= 0
        err = (out[valid].float() - ref[valid].float()).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > K3_TOL:
            raise AssertionError(f"K3 T={T}: max_abs_err {err} > {K3_TOL}")
        ms, plain_ms = alternate_times(
            lambda: kernels.ragged_prefill_attention_plain(q, k, v, seg),
            lambda: kernels.ragged_prefill_attention(q, k, v, seg),
            graph=True)
        eager_ms = cuda_time_ms(
            lambda: kernels.ragged_prefill_attention(q, k, v, seg))
        lib_ms, lib_err = sdpa_time(q, k, v, seg, ref)
        worst = max(worst, err)
        # causal pairs x (QK^T + PV) x heads x head dim
        flops = sum(n * (n + 1) // 2 for n in lens) * 4 * H * D
        nbytes = 2 * T * H * D * 2 + 2 * T * KH * D * 2 + T * 4
        r = result(worst, ms, plain_ms, bound(nbytes, flops, "bf16"),
                   lib_ms)
        log(f"K3 ragged_prefill_attention H={H} KH={KH} D={D} "
            f"tile={kernels.plan_prefill_tiles(T, H, KH)} T={T} "
            f"segments={lens} "
            f"valid={int(valid.sum())} max_abs_err={err:.3e} (tol {K3_TOL}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} eager_call_ms="
            f"{eager_ms:.4f} TFLOP/s={flops / (ms * 1e-3) / 1e12:.2f} "
            f"{bound_text(r)} "
            f"(sdpa max_abs_err {lib_err:.3e})")
        res = r
    return res


def sdpa_time(q, k, v, seg, ref) -> tuple[float, float]:
    """The library yardstick of K3: one scaled_dot_product_attention call
    with the block-diagonal causal boolean mask and grouped KV heads, the
    mask and layouts made outside the timed region, timed twice as K3 is
    (graph replay). Returns its ms and its error on the valid rows against
    the plain version."""
    import torch
    import torch.nn.functional as F

    T, H, _ = q.shape
    KH = k.shape[1]
    idx = torch.arange(T, device=q.device)
    mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
            & (idx[:, None] >= idx[None, :]))
    qh = q.transpose(0, 1).unsqueeze(0)
    kh = k.transpose(0, 1).unsqueeze(0)
    vh = v.transpose(0, 1).unsqueeze(0)

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    out = call()[0].transpose(0, 1)
    valid = seg >= 0
    err = (out[valid].float() - ref[valid].float()).abs().max().item()
    t1 = cuda_time_ms(call, graph=True)
    t2 = cuda_time_ms(call, graph=True)
    return (t1 + t2) / 2, err


#: the small backbone's head layouts: (query heads, KV heads, head dim,
#: q/k norms, Llama-3.1 rope at theta 5e5 (else theta 1e6))
BACKBONE_HEADS = {"qwen3": (4, 2, 128, True, False),
                  "orpheus": (6, 2, 128, False, True),
                  "csm": (8, 2, 64, False, True)}


def check_backbone(kv: str = "combined", heads: str = "qwen3") -> None:
    """Small talker backbone: card (bf16, kernels) vs CPU (f32, plain), over
    the combined full-precision pool ("combined"), an int8 or f8_e4m3 one,
    or the head-major pair ("pair"). ``heads`` (``BACKBONE_HEADS``): Qwen3's
    4 query heads over 2 with q/k norms, Orpheus's GQA group of 3 (6 over
    2) or CSM's group of 4 at head dim 64 (8 over 2), both with Llama-3.1
    rope scaling."""
    import torch

    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     backbone_forward,
                                                     init_backbone_params)
    from vox_serve_tpu_torch.ops.attention import AttnMetadata
    from vox_serve_tpu_torch.ops.kv_cache import KVCacheConfig, alloc_kv_pages
    from vox_serve_tpu_torch.params import tree_to_torch

    H, KH, D, qk_norm, llama31 = BACKBONE_HEADS[heads]
    cfg = BackboneConfig(vocab_size=64, hidden_size=256, num_layers=2,
                         num_heads=H, num_kv_heads=KH, head_dim=D,
                         intermediate_size=512, qk_norm=qk_norm,
                         rope_theta=5e5 if llama31 else 1e6,
                         llama31_rope_scaling=llama31, dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    params = init_backbone_params(cfg, g, "cpu")
    lens, page, P = (37, 20), 16, 16
    T = sum(lens)
    x0 = torch.randn((T, 256), generator=g)
    xs = [torch.randn((len(lens), 256), generator=g) for _ in range(3)]
    pages = [[1, 2, 3, 4], [5, 6, 7, 8]]

    def run(device, dtype):
        import dataclasses

        c = dataclasses.replace(cfg, dtype=dtype)
        p = tree_to_torch(params, device, dtype)
        kvc = KVCacheConfig(2, P, page, KH, D, dtype=dtype,
                            combined=kv != "pair",
                            quant=kv if kv in ("int8", "f8_e4m3") else "none",
                            k_amax=4.0, v_amax=4.0)
        pools = alloc_kv_pages(kvc, device)
        seg = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)])
        pos = torch.cat([torch.arange(n) for n in lens])
        pid = torch.cat([torch.tensor(pages[i])[torch.arange(n) // page]
                         for i, n in enumerate(lens)])
        off = pos % page

        def t(a):
            return a.to(torch.int32).to(device)

        meta = AttnMetadata(True, t(pid), t(off), segment_ids=t(seg),
                            q_positions=t(pos))
        outs = [backbone_forward(p, c, x0.to(device, dtype), t(pos), meta,
                                 *pools, kvc.kv_scales)]
        for s, x in enumerate(xs):
            cur = torch.tensor([n + s for n in lens])
            meta = AttnMetadata(
                False, t(torch.tensor([pages[i][int(cur[i]) // page]
                                       for i in range(len(lens))])),
                t(cur % page), block_tables=t(torch.tensor(pages)),
                seq_lens=t(cur + 1))
            outs.append(backbone_forward(p, c, x.to(device, dtype), t(cur),
                                         meta, *pools, kvc.kv_scales))
        return [o.float().cpu() for o in outs]

    ref = run("cpu", torch.float32)
    got = run("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, ref))
    if rel > BACKBONE_REL_TOL:
        raise AssertionError(f"backbone ({kv} KV) on card vs CPU: rel err "
                             f"{rel}")
    layout = (f"{H}/{KH} heads, D={D}"
              + (", Llama-3.1 rope" if llama31 else ""))
    log(f"backbone (2x256, {layout}, prefill {list(lens)} + 3 decode steps, "
        f"{kv} KV) card bf16 kernels vs CPU f32 plain: max rel err "
        f"{rel:.3e} (tol {BACKBONE_REL_TOL})")


#: K2's decoder blocks at one detokenize of 10 frames: (C, T)
K2_BLOCKS = ((768, 320), (384, 1600), (192, 6400), (96, 19200))


def check_k2(dtype_name: str = "float32") -> dict:
    """K2 against its plain version at the decoder blocks of one detokenize
    of 4 streams x 10 frames and of one stream: whole (zero halos) and as
    two streamed chunks with caches. float32: the plain chain of three
    _residual_units with TF32 off, each multiply-add on the card three TF32
    products; bfloat16: the Pallas kernel's bf16 rounding points, bf16
    parameters as the codec serves them at codec_dtype bfloat16, one bf16
    product per multiply-add. Returns the B=4 errors and four-block times."""
    import torch

    from vox_serve_tpu_torch.codecs.layers import init_conv1d
    from vox_serve_tpu_torch.ops import resunit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    name, tol = ("K2-bf16", K2_BF16_REL_TOL) if bf16 else ("K2", K2_REL_TOL)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    res = {}
    for B in (4, 1):
        worst_abs = worst_rel = 0.0
        ms_sum = plain_sum = flops_sum = 0.0
        for C, T in K2_BLOCKS:
            units = []
            for _ in range(3):
                def small():
                    return (torch.randn((C,), generator=g, device=dev)
                            * 0.2).to(dtype)
                units.append({"alpha1": small(), "beta1": small(),
                              "conv1": init_conv1d(g, C, C, 7, dev,
                                                   dtype=dtype),
                              "alpha2": small(), "beta2": small(),
                              "conv2": init_conv1d(g, C, C, 1, dev,
                                                   dtype=dtype)})
            x = (torch.randn((B, C, T), generator=g, device=dev)
                 * 0.5).to(dtype)
            caches = [(torch.randn((B, C, 6 * d), generator=g, device=dev)
                       * 0.5).to(dtype) for d in (1, 3, 9)]
            t1 = T // 2
            checks = []
            out = resunit.fused_resunit_stack(x, units, None)[0]
            ref = resunit.fused_resunit_stack_plain(x, units, None)[0]
            checks.append(("whole", out, ref))
            o1, c1 = resunit.fused_resunit_stack(x[..., :t1], units, caches)
            o2, c2 = resunit.fused_resunit_stack(x[..., t1:], units, c1)
            r1, d1 = resunit.fused_resunit_stack_plain(x[..., :t1], units,
                                                       caches)
            r2, d2 = resunit.fused_resunit_stack_plain(x[..., t1:], units,
                                                       d1)
            checks += [("chunk1", o1, r1), ("chunk2", o2, r2)]
            checks += [(f"cache{u}", a, b)
                       for u, (a, b) in enumerate(zip(c2, d2))]
            torch.cuda.synchronize()
            errs = []
            for what, a, b in checks:
                if a.dtype != dtype or b.dtype != dtype:
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         f"{a.dtype} / {b.dtype}")
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         "not finite")
                e = (a - b).abs().max().item()
                rel = e / max(b.abs().max().item(), 1e-30)
                if rel > tol:
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         f"rel err {rel} > {tol}")
                errs.append((e, rel))
            ms, plain_ms = alternate_times(
                lambda: resunit.fused_resunit_stack_plain(x, units, None),
                lambda: resunit.fused_resunit_stack(x, units, None),
                iters=10)
            # per unit: 7*C + C multiply-adds per output sample-channel
            flops = 3 * 2 * 8 * C * C * B * T
            e_abs = max(e for e, _ in errs)
            e_rel = max(r for _, r in errs)
            worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel,
                                                              e_rel)
            ms_sum, plain_sum, flops_sum = (ms_sum + ms, plain_sum + plain_ms,
                                            flops_sum + flops)
            bm, bn = resunit.plan_tiles(B, C, T, sms)
            log(f"{name} fused_resunit_stack B={B} C={C} T={T} tile {bm}x{bn}"
                f" (whole + 2 streamed chunks, caches) max_abs_err="
                f"{e_abs:.3e} max_rel_err={e_rel:.3e} (tol {tol} rel)"
                f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} TFLOP/s="
                f"{flops / (ms * 1e-3) / 1e12:.2f} plain_TFLOP/s="
                f"{flops / (plain_ms * 1e-3) / 1e12:.2f}")
        # x in and out (and no caches: the timed call is whole), the three
        # units' weights once (conv weights in the kernel's type, biases and
        # snake constants float32); float32 runs each multiply-add as three
        # TF32 tensor-core products (3xTF32) at the TF32 peak, bf16 as one
        # bf16 product at the bf16 peak
        elem = 2 if bf16 else 4
        nbytes = sum(elem * 2 * B * C * T + 3 * (elem * 8 * C * C + 4 * 6 * C)
                     for C, T in K2_BLOCKS)
        bnd = (bound(nbytes, flops_sum, "bf16") if bf16
               else bound(nbytes, 3 * flops_sum, "tf32"))
        r = result(worst_abs, ms_sum, plain_sum, bnd)
        r["max_rel_err"] = worst_rel
        log(f"{name} all four blocks B={B}: kernel_ms={ms_sum:.4f} plain_ms="
            f"{plain_sum:.4f} TFLOP/s={flops_sum / (ms_sum * 1e-3) / 1e12:.2f}"
            f" plain_TFLOP/s={flops_sum / (plain_sum * 1e-3) / 1e12:.2f} "
            f"max_rel_err={worst_rel:.3e} (tol {tol}) {bound_text(r)}")
        res[B] = r
    worst = max(r["max_abs_err"] for r in res.values())
    return {**res[4], "max_abs_err": worst,
            "max_rel_err": max(r["max_rel_err"] for r in res.values())}


# ---------------------------------------------------------------------------
# phase 4b: CSM's codec and watermark
# ---------------------------------------------------------------------------

# relative to max |reference|: the float32 Mimi decoder on the card (TF32
# off) against the CPU, the same math summed in another order; streamed
# chunks against the whole decode on the card (position-exact masks: only
# the summation order differs); the bf16 codec against float32 (2^-5,
# about 3x the 1.1e-2 the CPU measures at these shapes)
MIMI_REL_TOL = 1e-4
MIMI_CHUNK_REL_TOL = 1e-5
MIMI_BF16_REL_TOL = 2.0 ** -5
# the spectral watermark, card vs CPU, absolute on audio in [-1, 1] (float32
# FFTs in another order); SilentCipher's encode, relative to max |ref|
WATERMARK_TOL = 1e-5
SC_REL_TOL = 1e-4


def check_codec() -> dict:
    """CSM's detokenize path at full width: the Mimi decoder (random
    weights from a seed) for 4 streams x 10 frames, whole and as two
    streamed chunks (4 + 6 frames) with caches, on the card against the CPU
    in float32, then cast to bf16 (the codec at ``--codec-dtype bfloat16``)
    against float32; the spectral watermark over one 19,200-sample chunk
    per stream, its resample to 44.1 kHz and SilentCipher's encode (random
    params, a 512-row message band) over a chunk of noise at that rate,
    card vs CPU. Prints CUDA-event times (graph
    replays) of each."""
    import torch

    from vox_serve_tpu_torch.codecs import mimi
    from vox_serve_tpu_torch.params import tree_map
    from vox_serve_tpu_torch.watermark import (SILENTCIPHER_KEY,
                                               WatermarkConfig,
                                               apply_watermark,
                                               init_watermarker)
    from vox_serve_tpu_torch.watermark import silentcipher as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mimi.MimiConfig()
    g = torch.Generator().manual_seed(6)
    params = mimi.init_mimi(cfg, g, "cpu")
    B, T, cut = 4, 10, 4
    codes = torch.randint(0, 2048, (B, 32, T), generator=g)

    def to(tree, device, dtype=None):
        return tree_map(lambda a: a.to(device, dtype) if dtype is not None
                        and a.dtype == torch.float32 else a.to(device), tree)

    def decode(p, device, dtype=None):
        c = codes.to(device)
        whole = mimi.mimi_decode_chunk(p, cfg, c, None)[0]
        cache0 = to(mimi.mimi_init_cache(cfg, B, device), device, dtype)
        a, cache = mimi.mimi_decode_chunk(p, cfg, c[..., :cut], cache0)
        cache = tree_map(lambda x, r: x.to(r.dtype), cache, cache0)
        b, _ = mimi.mimi_decode_chunk(p, cfg, c[..., cut:], cache)
        return whole.float().cpu(), torch.cat([a, b], -1).float().cpu()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    ref_whole, ref_chunks = decode(params, "cpu")
    pc = to(params, dev)
    whole, chunks = decode(pc, dev)
    pb = to(params, dev, torch.bfloat16)
    b_whole, b_chunks = decode(pb, dev, torch.bfloat16)
    errs = {"card_vs_cpu": max(rel(whole, ref_whole), rel(chunks, ref_chunks)),
            "chunks_vs_whole": rel(chunks, whole),
            "bf16_vs_f32": max(rel(b_whole, ref_whole),
                               rel(b_chunks, ref_whole)),
            "bf16_chunks_vs_whole": rel(b_chunks, b_whole)}
    tols = {"card_vs_cpu": MIMI_REL_TOL, "chunks_vs_whole": MIMI_CHUNK_REL_TOL,
            "bf16_vs_f32": MIMI_BF16_REL_TOL,
            "bf16_chunks_vs_whole": MIMI_BF16_REL_TOL}
    shape = (B, 1, T * cfg.frame_samples)
    for out in (whole, chunks, b_whole, b_chunks):
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"Mimi decode: shape {tuple(out.shape)} or "
                                 "not finite")
    for k, e in errs.items():
        if e > tols[k]:
            raise AssertionError(f"Mimi {k}: rel err {e} > {tols[k]}")
    c = codes.to(dev)
    ms = {dt: cuda_time_ms(lambda p=p: mimi.mimi_decode_chunk(p, cfg, c, None),
                           iters=5, graph=True)
          for dt, p in (("f32", pc), ("bf16", pb))}
    log(f"Mimi decoder (full width: 8 x 512 transformer, window 250, SEANet "
        f"rates {cfg.upsample_ratios}) B={B} x {T} frames, whole and "
        f"{cut} + {T - cut} streamed: "
        + " ".join(f"{k}={v:.3e} (tol {tols[k]})" for k, v in errs.items())
        + f"; graph ms per decode f32={ms['f32']:.3f} bf16={ms['bf16']:.3f} "
        f"({T / 12.5 * 1e3:.0f} ms of audio per stream)")

    wcfg = WatermarkConfig()
    wp = init_watermarker(wcfg, torch.Generator().manual_seed(101), "cpu")
    audio = ref_whole[:, 0]
    ref = apply_watermark(wp, wcfg, audio)
    wpc, ac = to(wp, dev), audio.to(dev)
    got = apply_watermark(wpc, wcfg, ac).cpu()
    wm_err = (got - ref).abs().max().item()
    if not torch.isfinite(got).all() or wm_err > WATERMARK_TOL:
        raise AssertionError(f"spectral watermark card vs CPU: {wm_err}")
    wm_ms = cuda_time_ms(lambda: apply_watermark(wpc, wcfg, ac), graph=True)
    log(f"spectral watermark B={B} x {audio.shape[1]} samples: card vs CPU "
        f"max_abs_err={wm_err:.3e} (tol {WATERMARK_TOL}); graph ms "
        f"{wm_ms:.3f}; mark size {(ref - audio).abs().max().item():.3e}")

    # the message band cut to 512 rows, as in the JAX package's parity
    # test: the default 1024 exceeds the 513 bins of a 1024-point STFT
    scfg = sc.SilentCipherConfig(message_band_size=512)
    scp = sc.init_silentcipher(scfg, g, "cpu")
    onehot = torch.from_numpy(sc.message_to_symbols(list(SILENTCIPHER_KEY),
                                                    scfg))
    y = sc.sinc_resample(audio[:1], wcfg.sample_rate, scfg.sr)
    up_err = (sc.sinc_resample(ac[:1], wcfg.sample_rate, scfg.sr).cpu()
              - y).abs().max().item()
    if up_err > WATERMARK_TOL:
        raise AssertionError(f"sinc_resample card vs CPU: {up_err}")
    # the encode over white noise of the resampled chunk's length: a bin
    # with next to no energy (above the resampled audio's 12 kHz band)
    # takes its phase from rounding, and the mark's energy lands there
    # with that phase, so only a signal with energy in every bin compares
    # sample for sample
    y = torch.randn(y.shape, generator=g) * 0.1
    ref = sc.sc_encode(scp, scfg, y, onehot)
    scc, yc, oc = to(scp, dev), y.to(dev), onehot.to(dev)
    got = sc.sc_encode(scc, scfg, yc, oc).cpu()
    sc_err = rel(got, ref)
    if not torch.isfinite(got).all() or sc_err > SC_REL_TOL:
        raise AssertionError(f"sc_encode card vs CPU: rel err {sc_err}")
    sc_ms = cuda_time_ms(lambda: sc.sc_encode(scc, scfg, yc, oc), iters=5,
                         graph=True)
    log(f"SilentCipher: sinc_resample 24 -> 44.1 kHz card vs CPU "
        f"max_abs_err={up_err:.3e} (tol {WATERMARK_TOL}); sc_encode (random "
        f"params) 1 x {y.shape[1]} samples of noise at 44.1 kHz: card vs CPU "
        f"max_rel_err={sc_err:.3e} (tol {SC_REL_TOL}); graph ms {sc_ms:.3f}")
    return {**errs, "watermark": wm_err, "sc_encode": sc_err}


# ---------------------------------------------------------------------------
# phase 5: end to end over HTTP
# ---------------------------------------------------------------------------

PROMPTS = [
    "Streaming speech from the port.",
    "Four requests share one batch..",
    "Every frame runs both kernels!!",
    "The codec turns codes to audio.",
]
SAMPLE_RATE = 24000
#: the published ids whose synthetic snapshots the checkpoint phase writes
QWEN3_BASE = "Qwen/Qwen3-TTS-12Hz-1.7B-Base"
QWEN3_DESIGN = "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign"
QWEN3_CODEC = "Qwen/Qwen3-TTS-Tokenizer-12Hz"
CSM_ID = "sesame/csm-1b"
ORPHEUS_ID = "canopylabs/orpheus-3b-0.1-ft"
SNAC_ID = "hubertsiuzdak/snac_24khz"
SC_ID = "sony/silentcipher"
#: the ``--model`` each run serves (``qwen3-tts`` unless listed here); L, M
#: and N by published id, from the checkpoint phase's hub cache
MODEL_OF = {"I": "orpheus", "J": "csm", "K": "csm", "L": QWEN3_BASE,
            "M": QWEN3_DESIGN, "N": CSM_ID}
#: the family of a served id (its layers, audio unit and form fields)
FAMILY = {"orpheus": "orpheus", "csm": "csm", CSM_ID: "csm"}


def family(config: str) -> str:
    return FAMILY.get(MODEL_OF.get(config, "qwen3-tts"), "qwen3-tts")


#: ``--max-tokens`` where a run's prompts are longer than the family's
#: default budget: L's ICL prompts carry 38 reference frames and the
#: reference transcript, M's the instruct text, N's the default
#: two-speaker context (its two transcripts, 946 characters through the
#: char-level dev tokenizer, and two 0.96 s prompt WAVs)
MAX_TOKENS = {"L": 200, "M": 140, "N": 1072}


def max_tokens(config: str) -> int:
    return MAX_TOKENS.get(config, MODELS[family(config)]["max_tokens"])
#: per model: ``--max-tokens`` (absolute positions), and the audio unit a
#: run counts with its samples: a Qwen3 codec frame (42-token prompts ->
#: ~60 frames), or one Orpheus window (7 tokens; 42-token prompts -> ~119
#: tokens, 14 overlapped windows)
MODELS = {
    "qwen3-tts": {"max_tokens": 100, "unit": "frames", "unit_samples": 1920},
    "orpheus": {"max_tokens": 160, "unit": "windows", "unit_samples": 2048},
    "csm": {"max_tokens": 100, "unit": "frames", "unit_samples": 1920},
}
#: per model: backbone layers (each decode step launches the decode kernel
#: once per layer, each prefill K3 once per layer)
LAYERS = {"qwen3-tts": 28, "orpheus": 28, "csm": 16}
#: per model: the /generate form fields besides the text (CSM's speaker is
#: an integer id)
FORM = {"csm": {"speaker": "0"}}
#: Qwen3's and CSM's detokenize interval (frames) and samples per frame
FRAME_WINDOWS = (10, 1920)
#: Orpheus's detokenize window, overlap and samples kept per window
ORPHEUS_WINDOW = (28, 21, 2048)


def overlap_pcm_samples(n_tokens: int, interval: int = 28, overlap: int = 21,
                        window: int = 2048) -> int:
    """The PCM a stream of ``n_tokens`` audio tokens must emit under the
    overlap trim rule: windows every ``interval - overlap`` tokens until
    one reaches the last token, ``window`` samples each, a last window of
    fewer than ``interval - overlap`` tokens trimmed (the worker's
    ``_resolve_detok`` and the scheduler's window selection)."""
    step, s, total = interval - overlap, 0, 0
    while True:
        last = min(interval, n_tokens - s)
        total += window if last >= step else max(
            int(window * (last - 0.5) / step), 0)
        if s + interval >= n_tokens:
            return total
        s += step

K1, K1Q, K4 = ("paged_decode_attention", "paged_decode_attention_quant",
               "paged_decode_attention_pair")
K3, K2 = "ragged_prefill_attention", "fused_resunit_stack"
K2H = "fused_resunit_stack_bf16"

#: served configurations: name -> (launch flags, environment, what the
#: daemon must report it served, kernels that must launch). Every other
#: kernel must not launch in that run.
SINGLE = {"fused_decode_steps": 0, "pipeline_depth": 0,
          "first_chunk_frames": 0}
#: what A-F serve besides: the online scheduler, the codec in float32 and
#: the whole generation budget reserved at admission, no watermark
ONLINE_F32 = {"scheduler_type": "online", "codec_dtypes": ["float32"],
              "kv_reserve_fraction": 1.0, "watermark": None}
BF16_CODEC = ["--codec-dtype", "bfloat16"]
FUSED = ["--fused-decode-steps", "4", "--fused-decode-buckets", "1,4",
         "--pipeline-depth", "2"]
CONFIGS = {
    "A": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32},
          {K1, K3}),
    "B": (["--kv-quant", "int8"], {"VOX_FUSED_RESUNIT": "1"},
          {"kv_layout": "combined", "kv_pool_dtype": "int8",
           "fused_resunit": True, **SINGLE, **ONLINE_F32}, {K1Q, K3, K2}),
    "C": (["--kv-quant", "f8_e4m3"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "float8_e4m3fn",
           "fused_resunit": False, **SINGLE, **ONLINE_F32}, {K1Q, K3}),
    "D": ([], {"VOX_KV_COMBINED": "0"},
          {"kv_layout": "pair", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, **SINGLE, **ONLINE_F32}, {K4, K3}),
    "E": (FUSED, {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 0, **ONLINE_F32},
          {K1, K3}),
    "F": (["--first-chunk-frames", "3", *FUSED, "--detok-pipeline-depth",
           "2"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 3,
           "detok_pipeline_depth": 2, **ONLINE_F32}, {K1, K3}),
    "G": ([*BF16_CODEC, "--scheduler-type", "input_streaming",
           "--kv-reserve-fraction", "0.05"], {"VOX_FUSED_RESUNIT": "1"},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": True, **SINGLE,
           "scheduler_type": "input_streaming", "codec_dtypes": ["bfloat16"],
           "kv_reserve_fraction": 0.05}, {K1, K3, K2H}),
    "H": ([*BF16_CODEC, "--scheduler-type", "offline"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, **SINGLE, "scheduler_type": "offline",
           "codec_dtypes": ["bfloat16"], "kv_reserve_fraction": 1.0},
          {K1, K3}),
    # Orpheus-3B (MODEL_OF): G = 3 in K1 and K3, the float32 SNAC codec in
    # overlapped windows, no first-chunk ramp (an overlap codec turns it off)
    "I": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32},
          {K1, K3}),
    # CSM-1B (MODEL_OF): G = 4 at D=64 in K1 and K3, 16 layers, the
    # 31-codebook depth step in every decode graph, the Mimi codec with its
    # transformer ring in the slot cache, the spectral watermark in every
    # detokenize graph. K: the paths of the JAX csm profile at this batch
    # (bf16 codec, first-chunk ramp, fused decode, pipelines); CSM's rows do
    # not chain (the JAX model's flag), so no cold chain
    "J": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "spectral"}, {K1, K3}),
    "K": ([*BF16_CODEC, "--first-chunk-frames", "3", *FUSED,
           "--detok-pipeline-depth", "2"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 3,
           "detok_pipeline_depth": 2, "scheduler_type": "online",
           "codec_dtypes": ["bfloat16"], "kv_reserve_fraction": 1.0,
           "watermark": "spectral"}, {K1, K3}),
}
#: what L, M and N load from their snapshots: a part False (random init
#: after a failed mapping) or missing fails the run
QWEN3_LOADED = {"talker": True, "codec": True, "codec_encoder": True}
CONFIGS.update({
    # Qwen3-TTS Base from a full-width synthetic checkpoint: two ICL voice
    # clones (an uploaded reference WAV and its transcript: the ECAPA
    # x-vector and the Mimi encoder's reference frames in the prompt), one
    # x-vector-only clone, one request without audio
    "L": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**QWEN3_LOADED, "speaker_encoder": True}},
          {K1, K3}),
    # VoiceDesign: the same talker without a speaker encoder, two instruct
    # streams, no speaker row
    "M": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**QWEN3_LOADED, "speaker_encoder": None}},
          {K1, K3}),
    # J's configuration from the sesame/csm-1b snapshot: the backbone, the
    # Mimi codec and its encoder, the default two-speaker context in every
    # prompt
    "N": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "spectral", "tokenizer_loaded": False,
                   "checkpoint": {"backbone": True, "codec": True,
                                  "codec_encoder": True}}, {K1, K3}),
})
#: the runs served from random weights, and those from checkpoints (the
#: checkpoint phase writes their snapshots)
RANDOM_RUNS = "ABCDEFGHIJK"
#: the waves of concurrent requests a run serves, in turn (F's solo stream
#: first: alone, the online scheduler takes the cold-start chain)
WAVES = {"F": (1, 4), "M": (2,)}
#: per run, each request's form fields besides the text and whether it
#: uploads the reference WAV (``audio``); other runs send FORM's fields
REF_TEXTS = ("A short reference clip for the voice clone.",
             "Another transcript of the same reference.")
INSTRUCTS = ("A warm, low voice, speaking slowly.",
             "Bright and fast, like a sports announcer.")
REQUESTS = {
    "L": [{"fields": {"language": "english", "ref_text": REF_TEXTS[0]},
           "audio": True},
          {"fields": {"language": "english", "ref_text": REF_TEXTS[1]},
           "audio": True},
          {"fields": {"language": "english", "x_vector_only_mode": "true"},
           "audio": True},
          {"fields": {"language": "english"}}],
    "M": [{"fields": {"language": "english", "instruct": i}}
          for i in INSTRUCTS],
}
#: the reference clip L uploads: 3 s at 24 kHz
REF_SAMPLES = 72000
#: the prompt WAVs of the synthetic sesame/csm-1b snapshot: 0.96 s each
CSM_PROMPT_SAMPLES = 23040
#: the requests of a wave that use the text-stream protocol (G: 2 of 4; the
#: rest POST /generate)
TEXT_STREAMS = {"G": 2}
#: the step kinds that run the LM (H: every detokenize replay after them)
LM_KINDS = ("prefill", "decode", "decode_multi", "decode_multi_detok",
            "cold_chain")


def mimi_frames(n_samples: int, ratios=(8, 6, 5, 4)) -> int:
    """Frames the Mimi encoder makes of ``n_samples``: each strided causal
    conv pads its last frame whole (ceil), then the x2 downsample."""
    n = n_samples
    for r in (*reversed(ratios), 2):
        n = -(-n // r)
    return n


def synth_wav(n_samples: int, seed: int) -> bytes:
    """A 24 kHz mono PCM16 WAV of a voiced-like signal (harmonics of a
    gliding pitch under a syllable-rate envelope)."""
    import io
    import wave

    import numpy as np

    t = np.arange(n_samples) / SAMPLE_RATE
    f0 = 110.0 + 30.0 * seed + 20.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
    pcm = (x / np.abs(x).max() * 12000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def expected_prompt_tokens(config: str, i: int, text: str) -> int:
    """The prompt length request ``i`` of a run must have under the
    char-level dev tokenizer (every snapshot here ships none): Qwen3's role
    rows (3), think prefix with the English id (4), the speaker x-vector
    row (Base), tts_bos, the text, tts_eos + codec_bos; an ICL clone adds
    its reference transcript and the reference's codec frames; VoiceDesign
    adds its instruct template and has no speaker row. CSM: the default
    two-speaker context ("[spk]transcript" rows, each prompt WAV's Mimi
    frames and an EOS frame), then "[0]text"."""
    if family(config) == "csm":
        from vox_serve_tpu_torch.models.csm import CSMLM

        ctx = sum(len(f"[{spk}]{t}") + mimi_frames(CSM_PROMPT_SAMPLES) + 1
                  for spk, t in enumerate(CSMLM._PROMPT_TEXTS))
        return ctx + len(f"[0]{text}")
    fields = REQUESTS[config][i]["fields"]
    n = 3 + 4 + 1 + len(text) + 2
    if "instruct" in fields:
        return n + len(f"<|im_start|>user\n{fields['instruct']}"
                       "<|im_end|>\n")
    n += 1  # the x-vector row
    if "ref_text" in fields:
        n += len(fields["ref_text"]) + mimi_frames(REF_SAMPLES)
    return n


#: the runs whose prompts are held to ``expected_prompt_tokens``
PROMPT_LENGTHS = ("L", "M", "N")


def check_prompt_lengths(config: str, stats: dict, out: dict) -> None:
    """Each stream's prompt, as the daemon counted it, is exactly as long
    as its variant's rows: L's ICL prompts hold the reference's frames, M's
    have no speaker row, N's carry the default context."""
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    got = []
    for i, st in enumerate(out["streams"]):
        want = expected_prompt_tokens(config, i, PROMPTS[i])
        n = done[st["rid8"]]["prompt_tokens"]
        if n != want:
            raise AssertionError(f"[{config}] stream {i}: a prompt of {n} "
                                 f"tokens, its rows give {want}")
        got.append(n)
    log(f"[{config}] prompt lengths {got} as their rows give"
        + (f" (ICL: {mimi_frames(REF_SAMPLES)} reference frames each)"
           if config == "L" else ""))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path)
        return conn.getresponse().status
    finally:
        conn.close()


def multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    """A multipart/form-data body: text ``fields`` and ``files`` (name ->
    (filename, bytes)); returns (body, content type)."""
    boundary = f"vox{time.monotonic_ns()}"
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    for k, (fname, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\nContent-Type: '
                     'audio/wav\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def stream_generate(port: int, text: str, out: dict,
                    fields: dict | None = None,
                    audio: bytes | None = None) -> None:
    """POST /generate (urlencoded, or multipart with an uploaded ``audio``
    WAV) and read the streamed WAV, recording TTFA and wall time."""
    form = {"text": text, **(fields or {"speaker": "ryan",
                                        "language": "english"})}
    if audio is None:
        body = urllib.parse.urlencode(form)
        ctype = "application/x-www-form-urlencoded"
    else:
        body, ctype = multipart(form, {"audio": ("reference.wav", audio)})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        out["status"] = resp.status
        # "attachment; filename=stream_<first 8 of the request id>.wav"
        disp = resp.getheader("Content-Disposition") or ""
        out["rid8"] = disp.rsplit("stream_", 1)[-1].split(".")[0]
        data = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            data += chunk
            if "ttfa_s" not in out and len(data) > 44:
                out["ttfa_s"] = time.perf_counter() - t0
        out["wall_s"] = time.perf_counter() - t0
        out["body"] = data
    except Exception as e:  # recorded and raised by the caller
        out["error"] = repr(e)
    finally:
        conn.close()


def _post_form(port: int, path: str, fields: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=urllib.parse.urlencode(fields),
                     headers={"Content-Type":
                              "application/x-www-form-urlencoded"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def stream_text_input(port: int, text: str, out: dict) -> None:
    """The text-stream protocol: start a session, read its audio stream
    while three pieces of the text are sent ~150 ms apart (the first one
    past the scheduler's 20-character buffer), then end it. TTFA runs from
    the first piece to the first PCM byte."""
    cut = text.index(" ", 20)
    mid = (cut + len(text)) // 2
    pieces = [text[:cut], text[cut:mid], text[mid:]]
    reader: dict = {}
    try:
        status, body = _post_form(port, "/generate/stream/start",
                                  {"speaker": "ryan", "language": "english"})
        if status != 200:
            raise RuntimeError(f"stream start: status {status}")
        rid = json.loads(body)["request_id"]
        out["rid8"] = rid[:8]

        def read_audio():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                conn.request("GET", f"/generate/stream/{rid}/audio")
                resp = conn.getresponse()
                reader["status"] = resp.status
                data = b""
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    data += chunk
                    if "t_first" not in reader and len(data) > 44:
                        reader["t_first"] = time.perf_counter()
                reader["body"] = data
                reader["t_end"] = time.perf_counter()
            except Exception as e:
                reader["error"] = repr(e)
            finally:
                conn.close()

        th = threading.Thread(target=read_audio)
        th.start()
        t0 = time.perf_counter()
        for i, piece in enumerate(pieces):
            if i:
                time.sleep(0.15)
            status, _ = _post_form(port, f"/generate/stream/{rid}/text",
                                   {"text": piece})
            if status != 200:
                raise RuntimeError(f"stream text: status {status}")
        status, _ = _post_form(port, f"/generate/stream/{rid}/end", {})
        if status != 200:
            raise RuntimeError(f"stream end: status {status}")
        th.join(timeout=900)
        if "error" in reader or "t_first" not in reader:
            raise RuntimeError(f"audio stream: {reader.get('error')} status "
                               f"{reader.get('status')}")
        out.update(status=reader["status"], body=reader["body"],
                   ttfa_s=reader["t_first"] - t0,
                   wall_s=reader["t_end"] - t0, text_stream=True)
    except Exception as e:  # recorded and raised by the caller
        out["error"] = repr(e)


def serve_wave(config: str, port: int, prompts: list[str],
               text_streams: int = 0) -> tuple:
    """Stream ``prompts`` concurrently, the first ``text_streams`` of them
    through the text-stream protocol; check every response's PCM and
    return (results, audio units (frames or windows), wall seconds)."""
    import numpy as np

    spec = MODELS[family(config)]
    unit, per = spec["unit"], spec["unit_samples"]
    max_samples = (overlap_pcm_samples(max_tokens(config))
                   if family(config) == "orpheus"
                   else max_tokens(config) * per)

    results = [{} for _ in prompts]
    reqs = REQUESTS.get(config) or [
        {"fields": FORM.get(family(config))}] * len(prompts)
    ref = synth_wav(REF_SAMPLES, seed=0)
    threads = [threading.Thread(
        target=stream_text_input if i < text_streams else stream_generate,
        args=(port, p, r) if i < text_streams else (
            port, p, r, reqs[i].get("fields"),
            ref if reqs[i].get("audio") else None))
        for i, (p, r) in enumerate(zip(prompts, results))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    frames = 0.0
    for i, r in enumerate(results):
        if "error" in r or r.get("status") != 200:
            raise RuntimeError(f"request {i} failed: {r.get('error')} "
                               f"status {r.get('status')}")
        body = r["body"]
        if body[:4] != b"RIFF":
            raise AssertionError(f"request {i}: no WAV header")
        pcm = np.frombuffer(body[44:], dtype=np.int16)
        if pcm.size == 0 or (len(body) - 44) % 2:
            raise AssertionError(f"request {i}: empty or odd PCM")
        if pcm.size > max_samples:
            raise AssertionError(f"request {i}: {pcm.size} samples > "
                                 f"the budget's {max_samples}")
        if not np.isfinite(pcm.astype(np.float32)).all():
            raise AssertionError(f"request {i}: non-finite PCM")
        r["samples"] = pcm.size
        r["frames"] = pcm.size / per
        frames += r["frames"]
        how = "text stream" if r.get("text_stream") else "/generate"
        log(f"[{config}] {len(prompts)}-stream wave, request {i} ({how}): "
            f"{pcm.size} samples ({r['frames']:.1f} {unit}, "
            f"{pcm.size / SAMPLE_RATE:.2f} s audio, peak "
            f"{int(np.abs(pcm.astype(np.int32)).max())}), TTFA "
            f"{r['ttfa_s'] * 1e3:.1f} ms, wall {r['wall_s']:.2f} s")
    return results, frames, wall


def end_to_end(card: str, config: str, hub: str | None = None) -> dict:
    """Serve one configuration over HTTP; returns the daemon's launch
    counts, the 4-stream wave's frames/s and TTFA median, and the solo
    stream's TTFA (F), after checking what it served and which kernels and
    graphs ran. ``hub``: the Hugging Face hub cache the daemon resolves
    checkpoints in (``HF_HUB_CACHE``; L, M and N)."""
    flags, env_extra, served, must_run = CONFIGS[config]
    model = MODEL_OF.get(config, "qwen3-tts")
    fam = family(config)
    OUT.mkdir(exist_ok=True)
    port = free_port()
    stats_path = OUT / f"chip_smoke_server_stats_{config}.json"
    if stats_path.exists():
        stats_path.unlink()
    log_path = OUT / f"chip_smoke_server_{config}.log"
    server_log = open(log_path, "w")
    cmd = [sys.executable, "-m", "vox_serve_tpu_torch.launch",
           "--model", model, "--device", "cuda",
           "--host", "127.0.0.1", "--port", str(port),
           "--max-batch-size", "4", "--max-num-pages", "2048",
           "--max-tokens", str(max_tokens(config)), "--seed", "0",
           "--socket-suffix", f"_smoke{port}",
           "--stats-file", str(stats_path), *flags]
    env = {k: v for k, v in os.environ.items()
           if k not in ("VOX_FUSED_RESUNIT", "VOX_KV_COMBINED",
                        "HF_HUB_CACHE")}
    env.update(env_extra)
    if hub is not None:
        env["HF_HUB_CACHE"] = hub
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=server_log, env=env,
                            stderr=subprocess.STDOUT, start_new_session=True)
    out: dict = {}
    try:
        deadline = time.monotonic() + 600
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited ({proc.returncode})")
            try:
                if http_get(port, "/health") == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError("server not healthy within 600 s")
            time.sleep(0.5)
        log(f"[{config}] {' '.join(flags)} "
            f"{' '.join(f'{k}={v}' for k, v in env_extra.items())} server "
            f"ready in {time.perf_counter() - t_start:.1f} s")
        for n in WAVES.get(config, (len(PROMPTS),)):
            results, frames, wall = serve_wave(
                config, port, PROMPTS[:n], TEXT_STREAMS.get(config, 0))
            ttfa = sorted(r["ttfa_s"] for r in results)
            if n == 1:
                out["solo_ttfa_s"] = ttfa[0]
                continue
            out.update(frames=frames, wall=wall,
                       frames_per_s=frames / wall, ttfa=ttfa,
                       ttfa_median_s=(ttfa[(n - 1) // 2] + ttfa[n // 2]) / 2,
                       streams=[{k: r.get(k) for k in ("rid8", "samples",
                                                        "ttfa_s", "wall_s")}
                                for r in results])
            if TEXT_STREAMS.get(config):
                out["text_stream_ttfa"] = [r["ttfa_s"] for r in results
                                           if r.get("text_stream")]
                out["generate_ttfa"] = [r["ttfa_s"] for r in results
                                        if not r.get("text_stream")]
    except Exception:
        server_log.flush()
        tail = log_path.read_text().splitlines()[-80:]
        print("server log (last lines):\n" + "\n".join(tail),
              file=sys.stderr)
        raise
    finally:
        # SIGTERM to the launcher: it terminates its scheduler daemon, which
        # writes the stats file on the way out
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        # the daemon is in the same session: make sure nothing survives
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        server_log.close()

    for _ in range(100):
        if stats_path.exists() and stats_path.stat().st_size:
            break
        time.sleep(0.1)
    stats = json.loads(stats_path.read_text())
    out["launches"] = stats["launches"]
    check_run(config, card, stats, out)
    if fam == "orpheus":
        check_overlap_windows(config, stats, out)
    else:
        check_frame_streams(config, stats, out, fam == "csm")
    if config in PROMPT_LENGTHS:
        check_prompt_lengths(config, stats, out)
    return out


def frame_pcm_samples(n_tokens: int, ends: set) -> int:
    """The PCM a stream of ``n_tokens`` codec frames (Qwen3, CSM) must
    emit: windows tile the frames contiguously, 1920 samples a frame, and a
    last window holding fewer frames than its length keeps int(samples *
    (valid - 0.5) / length) (the JAX worker's ``_resolve_detok``), half a
    frame less. ``ends``: where windows end."""
    fs = FRAME_WINDOWS[1]
    return fs * n_tokens - (0 if n_tokens in ends else fs // 2)


def check_frame_streams(config: str, stats: dict, out: dict,
                        verbose: bool) -> None:
    """Each stream's PCM is exactly what the trim rule gives for the frames
    its daemon generated (a window dropped or emitted twice fails).
    Without the first-chunk ramp windows end every 10 frames; with it the
    ramp's mini windows (3, then 3 or 6 frames, unless the scheduler hands
    a stream to full windows early) end first, so a stream's last window is
    whole or trimmed by half a frame and both lengths are accepted.
    ``verbose`` (CSM) prints each stream's finish reason, TTFA and frames/s
    against real time (12.5 frames/s), and the decode and detokenize replay
    times."""
    interval, fs = FRAME_WINDOWS
    ramp = stats["first_chunk_frames"]
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        n = req["audio_tokens"]
        want = {frame_pcm_samples(n, set(range(0, n + 1, interval)))}
        if ramp:
            want |= {fs * n, fs * n - fs // 2}
        if n <= 0 or st["samples"] not in want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for {n} "
                f"frames, the trim rule gives {sorted(want)}")
        if verbose:
            log(f"[{config}] stream {i} ({st['rid8']}): {n} audio tokens "
                f"({req['finish_reason']}) -> {st['samples']} samples (rule:"
                f" {sorted(want)}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
                f"{st['samples'] / fs / st['wall_s']:.2f} frames/s (real "
                "time 12.50)")
    if not verbose:
        frames = [done[st["rid8"]]["audio_tokens"] for st in out["streams"]]
        log(f"[{config}] every stream's PCM follows the trim rule for its "
            f"frames {frames}")
        return
    probe = stats["steps"]["probe_ms"]
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    log(f"[{config}] CSM-1B: TTFA median {out['ttfa_median_s'] * 1e3:.1f} ms;"
        f" {out['frames_per_s']:.2f} frames/s aggregate over 4 streams (real "
        f"time: 12.50 per stream, 50.00 for 4); decode replay ms (probe) "
        + str({k: v for k, v in probe.items() if k.startswith("decode")})
        + "; detokenize replay ms (probe) "
        + str({k: v for k, v in probe.items() if k.startswith("detok ")})
        + f"; detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} ms per call")


def check_overlap_windows(config: str, stats: dict, out: dict) -> None:
    """Each Orpheus stream's PCM is exactly what the overlap rule gives for
    the audio tokens its daemon generated (a window dropped or emitted
    twice fails), at least 6 windows each; prints the run's TTFA, windows/s
    against real time (11.72 windows/s per stream) and the decode and
    detokenize replay times."""
    interval, overlap, window = ORPHEUS_WINDOW
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        want = overlap_pcm_samples(req["audio_tokens"], interval, overlap,
                                   window)
        if st["samples"] != want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for "
                f"{req['audio_tokens']} audio tokens, the overlap rule gives "
                f"{want}")
        if want < 6 * window:
            raise AssertionError(f"[{config}] stream {i}: {want // window} "
                                 "windows, expected at least 6")
        log(f"[{config}] stream {i} ({st['rid8']}): {req['audio_tokens']} "
            f"audio tokens ({req['finish_reason']}) -> {st['samples']} "
            f"samples = {st['samples'] // window} windows (overlap rule: "
            f"{want}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
            f"{st['samples'] / window / st['wall_s']:.2f} windows/s")
    realtime = SAMPLE_RATE / window
    probe = stats["steps"]["probe_ms"]
    dec = {k: v for k, v in probe.items() if k.startswith("decode ")}
    det = {k: v for k, v in probe.items() if k.startswith("detok ")}
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    log(f"[{config}] Orpheus-3B: TTFA median {out['ttfa_median_s'] * 1e3:.1f}"
        f" ms; {out['frames_per_s']:.2f} windows/s aggregate over 4 streams "
        f"(real time: {realtime:.2f} per stream, {4 * realtime:.2f} for 4); "
        f"decode replay ms (probe) {dec}; detokenize replay ms (probe) {det};"
        f" detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} ms per call")


def check_run(config: str, card: str, stats: dict, out: dict) -> None:
    """Print a served run's numbers and hold its stats file to what the
    configuration must have run (see the module docstring)."""
    _flags, _env, served, must_run = CONFIGS[config]
    model, fam = MODEL_OF.get(config, "qwen3-tts"), family(config)
    layers = LAYERS[fam]
    ph = stats["phase_stats"]
    steps = stats["steps"]
    n_steps = steps["decode_steps"]
    replays = steps["replays"]
    captured = steps["captured"]
    launches = stats["launches"]

    def per_call(kind):
        t = sum(ph.get(f"{kind}.{p}", (0.0, 0))[0]
                for p in ("plan", "dispatch", "resolve"))
        return t, ph.get(f"{kind}.dispatch", (0.0, 0))[1]

    t1, n1 = per_call("decode")
    tk, nk = per_call("decode_multi")
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    pre_t, pre_n = ph.get("prefill", (0.0, 0))
    pp_t, pp_n = ph.get("preprocess", (0.0, 0))
    wins, batches = ph.get("detok.windows", (0.0, 0))
    ttfa = out["ttfa"]
    solo = (f"; solo stream TTFA {out['solo_ttfa_s'] * 1e3:.1f} ms"
            if "solo_ttfa_s" in out else "")
    unit = MODELS[fam]["unit"]
    log(f"[{config}] e2e on {card}: {model}, {len(ttfa)} "
        f"streams, {out['frames']:.1f} {unit} in {out['wall']:.2f} s = "
        f"{out['frames_per_s']:.1f} {unit}/s "
        f"aggregate; TTFA min/median/max {ttfa[0] * 1e3:.1f}/"
        f"{out['ttfa_median_s'] * 1e3:.1f}/{ttfa[-1] * 1e3:.1f} ms{solo}; "
        f"decode step wall (plan + dispatch + resolve) "
        f"{(t1 + tk) / max(n_steps, 1) * 1e3:.2f} ms over {n_steps} steps "
        f"(single {t1 / max(n1, 1) * 1e3:.2f} ms x {n1} calls, fused "
        f"{tk / max(nk, 1) * 1e3:.2f} ms x {nk} calls); detokenize wall "
        f"{det_t / max(det_n, 1) * 1e3:.2f} ms per call over {det_n} calls "
        f"({batches} batches of {wins / max(batches, 1):.2f} windows); "
        f"prefill wall {pre_t / max(pre_n, 1) * 1e3:.2f} ms x {pre_n}; "
        f"preprocess {pp_t / max(pp_n, 1) * 1e3:.2f} ms x {pp_n}; "
        f"cold starts {steps['cold_starts']}; params LM "
        f"{stats['param_count']['lm'] / 1e9:.3f} B + codec "
        f"{stats['param_count']['codec'] / 1e6:.1f} M")
    log(f"[{config}] graphs: {len(steps['graphs'])} captured in "
        f"{steps['capture_s']:.2f} s, pool {steps['pool_mib']:.1f} MiB; "
        f"replays {replays}; eager calls {steps['eager_calls']}; deepest "
        f"pipelines: decode {steps['max_pending']}, detokenize "
        f"{steps['max_pending_detok']}; polled {steps['polled']}; device "
        f"ms per replay (start-up probe): "
        + ", ".join(f"{k}={v:.3f}" for k, v in steps["probe_ms"].items()))
    log(f"[{config}] served {stats['model']} "
        f"{({k: stats[k] for k in served})}; kernel "
        f"launches {launches}; resunit stacks {stats['resunit_stacks']} "
        f"(bf16 {stats['resunit_bf16_stacks']}); replay order "
        f"{steps['replay_spans']}")
    if "text_stream_ttfa" in out:
        log(f"[{config}] TTFA of the text streams (first piece to first PCM "
            "byte) " + ", ".join(f"{t * 1e3:.1f}" for t in
                                 out["text_stream_ttfa"])
            + " ms; of the /generate streams " + ", ".join(
                f"{t * 1e3:.1f}" for t in out["generate_ttfa"]) + " ms")
    if stats["model"] != model:
        raise AssertionError(f"[{config}] the daemon served {stats['model']}"
                             f", expected {model}")
    for key, want in served.items():
        if stats[key] != want:
            raise AssertionError(f"[{config}] served {key}={stats[key]!r}, "
                                 f"expected {want!r}")
    for name, n in launches.items():
        if name in must_run and n <= 0:
            raise AssertionError(f"[{config}] kernel {name} never launched "
                                 "on the main path")
        if name not in must_run and n != 0:
            raise AssertionError(f"[{config}] kernel {name} launched {n} "
                                 "times; this configuration must not run it")
    # every step was a graph replay: no step body ran eagerly, and every
    # kind the run needs was replayed
    if any(steps["eager_calls"].values()):
        raise AssertionError(f"[{config}] step bodies ran eagerly on the "
                             f"card: {steps['eager_calls']}")
    for kind in ("prefill", "detok"):
        if not replays.get(kind):
            raise AssertionError(f"[{config}] no {kind} graph was replayed")
    if not (replays.get("decode") or replays.get("decode_multi")):
        raise AssertionError(f"[{config}] no decode graph was replayed")
    # each replay counted the kernels its capture launched: K3 once per
    # talker layer and prefill, the decode kernel once per layer and step
    prefills = replays.get("prefill", 0) + replays.get("cold_chain", 0)
    if launches[K3] != layers * prefills:
        raise AssertionError(
            f"[{config}] {K3} launched {launches[K3]} times, expected "
            f"{layers} x {prefills} prefill and cold-chain replays")
    (decode_kernel,) = must_run & {K1, K1Q, K4}
    if launches[decode_kernel] != layers * n_steps:
        raise AssertionError(
            f"[{config}] {decode_kernel} launched {launches[decode_kernel]}"
            f" times, expected {layers} x {n_steps} decode steps")
    log(f"[{config}] {K3}: {launches[K3]} launches = {layers} layers x "
        f"{prefills} prefill replays; {decode_kernel}: "
        f"{launches[decode_kernel]} launches = {layers} layers x {n_steps} "
        "decode steps")
    # and every counter is the sum over graphs of replays x captured counts
    want = {name: 0 for name in launches}
    stacks = {K2: 0, K2H: 0}
    for c in captured.values():
        for name in want:
            want[name] += c["replays"] * c.get(f"{name}.launches", 0)
        for name in stacks:
            stacks[name] += c["replays"] * c.get(f"{name}.stacks", 0)
    got_stacks = {K2: stats["resunit_stacks"],
                  K2H: stats["resunit_bf16_stacks"]}
    if want != launches or stacks != got_stacks:
        raise AssertionError(
            f"[{config}] launches {launches} / stacks {got_stacks} differ "
            f"from the graphs' replays x captured counts {want} / {stacks}")
    k2 = K2H if served["codec_dtypes"] == ["bfloat16"] else K2
    if served["fused_resunit"] and stacks[k2] <= 0:
        raise AssertionError(f"[{config}] no {k2} stack ran in a graph")
    if served["scheduler_type"] == "offline":
        spans = steps["replay_spans"]
        last_lm = max(spans[k][1] for k in LM_KINDS if k in spans)
        if spans["detok"][0] <= last_lm:
            raise AssertionError(
                f"[{config}] a detokenize replay ({spans['detok']}) was "
                f"issued before the last LM step ({last_lm})")
    if served["fused_decode_steps"]:
        if not replays.get("decode_multi"):
            raise AssertionError(f"[{config}] no fused decode graph ran")
        if steps["max_pending"] < served["pipeline_depth"]:
            raise AssertionError(f"[{config}] the readback pipeline never "
                                 f"held {served['pipeline_depth']} steps")
    if served["first_chunk_frames"]:
        chained = replays.get("cold_chain", 0) + replays.get(
            "decode_multi_detok", 0)
        if fam == "csm" and chained:
            raise AssertionError(f"[{config}] CSM's rows chained: {replays}")
        if fam != "csm" and not replays.get("cold_chain"):
            raise AssertionError(f"[{config}] no cold chain was replayed")
        minis = {int(k.split()[2]) for k, c in captured.items()
                 if k.startswith("detok ") and c["replays"]}
        F = served["first_chunk_frames"]
        if not {F, 2 * F} <= minis:
            raise AssertionError(f"[{config}] detokenize lengths replayed "
                                 f"{sorted(minis)}, expected {F} and {2 * F}"
                                 " among them")
        if steps["max_pending_detok"] < served["detok_pipeline_depth"]:
            raise AssertionError(
                f"[{config}] the detokenize pipeline never held "
                f"{served['detok_pipeline_depth']} batches")


# ---------------------------------------------------------------------------
# phase 6: checkpoints in the published layouts, and runs L, M, N
# ---------------------------------------------------------------------------


def _rss_gb(key: str) -> float:
    """A size from /proc/self/status (VmRSS: the resident set), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


class RssPeak:
    """The peak resident set of this process while the block runs, GB:
    VmRSS sampled every 2 ms by a thread (the kernel's VmHWM is not
    offered everywhere, and cannot be reset everywhere)."""

    def __enter__(self):
        self.peak = _rss_gb("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _rss_gb("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gb("VmRSS"))


def _bits(t):
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def assert_bit_equal(label: str, written: dict, loaded: dict) -> int:
    """Every tensor the loader gave back (re-exported to the published
    names) has the dtype, shape and bits of the one written."""
    import torch

    if set(written) != set(loaded):
        raise AssertionError(f"[load] {label}: names differ: "
                             f"{sorted(set(written) ^ set(loaded))[:8]}")
    for k, w in written.items():
        r = loaded[k]
        if (r.dtype != w.dtype or tuple(r.shape) != tuple(w.shape)
                or not torch.equal(_bits(r).to(w.device), _bits(w))):
            raise AssertionError(f"[load] {label}: {k} differs from the "
                                 f"tensor written ({r.dtype} {tuple(r.shape)}"
                                 f" vs {w.dtype} {tuple(w.shape)})")
    return len(written)


def timed_load(label: str, files: list, load, written: dict,
               reexport, write_s: float) -> dict:
    """Resolve and load one snapshot onto the card (``load``), timed, with
    the peak resident set of this process over the load; then hold every
    tensor bit-equal to the written ones (``reexport`` maps the loaded
    tree back to the published names)."""
    import gc

    gc.collect()
    _sync()
    base = _rss_gb("VmRSS")
    with RssPeak() as rss:
        t0 = time.perf_counter()
        loaded = load()
        _sync()
        dt = time.perf_counter() - t0
    peak = rss.peak
    if loaded is None:
        raise AssertionError(f"[load] {label}: the loader fell back to "
                             "random init")
    n = assert_bit_equal(label, written, reexport(loaded))
    nbytes = sum(os.path.getsize(f) for f in files)
    params = sum(t.numel() for k, t in written.items()
                 if not k.endswith("num_batches_tracked"))
    r = {"gb": nbytes / 1e9, "s": dt, "gb_per_s": nbytes / 1e9 / dt,
         "peak_rss_gb": peak, "rss_before_gb": base, "write_s": write_s,
         "params": params, "tensors": n}
    log(f"[load] {label}: {r['gb']:.3f} GB in {len(files)} file(s), "
        f"{params / 1e9:.4f} B params (written in {write_s:.1f} s); "
        f"resolved through the hub cache and loaded onto the card in "
        f"{dt:.2f} s = {r['gb_per_s']:.2f} GB/s; peak RSS {peak:.2f} GB "
        f"(before {base:.2f} GB, sampled every 2 ms); {n} tensors "
        "bit-equal to those written")
    return r


def _free() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _files(snap) -> list:
    return sorted(str(p) for p in Path(snap).rglob("*") if p.is_file())


def _drop_snapshot(cache: Path, model_id: str) -> None:
    import shutil

    shutil.rmtree(cache / ("models--" + model_id.replace("/", "--")),
                  ignore_errors=True)


def checkpoint_phase(card: str) -> tuple[dict, dict]:
    """Write synthetic checkpoints at the published widths and names
    (random weights from seeds, through ``synthetic_checkpoints.py``'s
    exporters and the port's safetensors writer) into a temporary hub
    cache, one family at a time; load each on the card through the
    package's loaders (resolved by id through ``HF_HUB_CACHE``), holding
    every tensor bit-equal to the one written and printing bytes, seconds,
    GB/s and peak RSS; serve runs L and M (Qwen3-TTS Base and VoiceDesign)
    and N (CSM-1B) from those snapshots. Each snapshot is deleted after
    its run. Returns (load numbers, run results)."""
    import json as _json
    import shutil
    import tempfile

    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.mimi import (MimiConfig, init_mimi,
                                                 init_mimi_encoder)
    from vox_serve_tpu_torch.codecs.qwen3_codec import (Qwen3CodecConfig,
                                                        init_qwen3_codec)
    from vox_serve_tpu_torch.codecs.snac import SNACConfig, init_snac_decoder
    from vox_serve_tpu_torch.encoders.ecapa import EcapaConfig, init_ecapa
    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     seeded_generator)
    from vox_serve_tpu_torch.models.csm import CSMLM
    from vox_serve_tpu_torch.models.orpheus import OrpheusLM
    from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
    from vox_serve_tpu_torch.watermark import silentcipher as sc
    from vox_serve_tpu_torch.watermark import spectral

    dev = torch.device("cuda")
    cache = Path(tempfile.mkdtemp(prefix="vox_hub_"))
    saved_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(cache)
    loads, runs = {}, {}

    def write(model_id, state, shards):
        snap = synth.snapshot_dir(cache, model_id)
        t0 = time.perf_counter()
        synth.write_shards(snap, state, shards)
        return snap, time.perf_counter() - t0

    try:
        # -- Qwen3-TTS Base: talker, depth, speaker encoder; the codec ----
        src = Qwen3TTSLM(QWEN3_BASE, device=dev, seed=21)
        spk = init_ecapa(EcapaConfig(mel_dim=128, enc_dim=2048),
                         seeded_generator(dev, 22), dev)
        state = synth.export_qwen3(src.params, spk, torch.bfloat16)
        snap, ws = write(QWEN3_BASE, state, 2)
        (snap / "config.json").write_text(_json.dumps({"talker_config": {
            "spk_id": {"ryan": 2090, "vivian": 2091, "serena": 2092}}}))
        loads[QWEN3_BASE] = timed_load(
            QWEN3_BASE, _files(snap), src._load_checkpoint, state,
            lambda t: synth.export_qwen3(t, src._spk_enc_params,
                                         torch.bfloat16), ws)

        g = seeded_generator(dev, 23)
        codec = init_qwen3_codec(Qwen3CodecConfig(), g, dev)
        enc = init_mimi_encoder(MimiConfig(), g, dev)
        cstate = {**synth.export_qwen3_codec(codec),
                  **synth.export_mimi_encoder(enc, "encoder.")}
        csnap, ws = write(QWEN3_CODEC, cstate, 1)
        loads[QWEN3_CODEC] = timed_load(
            QWEN3_CODEC, _files(csnap), src._load_codec_params, cstate,
            lambda t: {**synth.export_qwen3_codec(t),
                       **synth.export_mimi_encoder(src._codec_encoder,
                                                   "encoder.")}, ws)
        if src._enc_mimi_cfg != MimiConfig():
            raise AssertionError("the codec encoder's config changed")
        del src, spk, codec, enc, cstate
        _free()
        runs["L"] = end_to_end(card, "L", hub=str(cache))

        # -- VoiceDesign: the same talker, no speaker encoder -------------
        _drop_snapshot(cache, QWEN3_BASE)
        design = {k: v for k, v in state.items()
                  if not k.startswith("speaker_encoder.")}
        del state
        write(QWEN3_DESIGN, design, 2)
        del design
        _free()
        runs["M"] = end_to_end(card, "M", hub=str(cache))
        _drop_snapshot(cache, QWEN3_DESIGN)
        _drop_snapshot(cache, QWEN3_CODEC)

        # -- CSM-1B with the Mimi codec and encoder, and its prompts ------
        src = CSMLM(CSM_ID, device=dev, seed=31)
        g = seeded_generator(dev, 32)
        codec = init_mimi(MimiConfig(), g, dev)
        enc = init_mimi_encoder(MimiConfig(), g, dev)
        state = synth.export_csm(src.params, codec, enc)
        snap, ws = write(CSM_ID, state, 2)
        (snap / "prompts").mkdir()
        for i, name in enumerate(("conversational_a", "conversational_b")):
            (snap / "prompts" / f"{name}.wav").write_bytes(
                synth_wav(CSM_PROMPT_SAMPLES, seed=1 + i))

        def csm_reexport(t):
            shared = synth.share_mimi_codebooks(t["codec"], t["encoder"])
            for grp in ("rvq_first", "rvq_rest"):
                for k in ("embed_sum", "usage"):
                    if not torch.equal(shared[grp][k], t["encoder"][grp][k]):
                        raise AssertionError("encoder codebooks differ")
            return synth.export_csm(t["params"], t["codec"], t["encoder"])

        loads[CSM_ID] = timed_load(CSM_ID, _files(snap), src._load_checkpoint,
                                   state, csm_reexport, ws)
        del src, codec, enc, state
        _free()
        runs["N"] = end_to_end(card, "N", hub=str(cache))
        _drop_snapshot(cache, CSM_ID)

        # -- Orpheus-3B at full width, 4 of its 28 layers; SNAC -----------
        cfg4 = BackboneConfig(
            vocab_size=156940, hidden_size=3072, num_layers=4, num_heads=24,
            num_kv_heads=8, head_dim=128, intermediate_size=8192,
            rope_theta=500000.0, llama31_rope_scaling=True)
        src = OrpheusLM(ORPHEUS_ID, device=dev, seed=41, debug_backbone=cfg4)
        state = synth.export_orpheus(src.params)
        snap, ws = write(ORPHEUS_ID, state, 2)
        loads[ORPHEUS_ID + " (4 of 28 layers)"] = timed_load(
            ORPHEUS_ID, _files(snap), src._load_params, state,
            synth.export_orpheus, ws)
        _drop_snapshot(cache, ORPHEUS_ID)
        del state

        snac = init_snac_decoder(SNACConfig(), seeded_generator(dev, 42), dev)
        sstate = synth.export_snac(snac, SNACConfig())
        snap = synth.snapshot_dir(cache, SNAC_ID)
        t0 = time.perf_counter()
        torch.save(sstate, snap / "pytorch_model.bin")
        loads[SNAC_ID] = timed_load(
            SNAC_ID, _files(snap), src._load_snac, sstate,
            lambda t: synth.export_snac(t, SNACConfig()),
            time.perf_counter() - t0)
        _drop_snapshot(cache, SNAC_ID)
        del src, snac, sstate

        # -- SilentCipher at the 512-row message band ----------------------
        scfg = sc.SilentCipherConfig(message_band_size=512)
        scp = sc.init_silentcipher(scfg, seeded_generator(dev, 43), dev)
        snap = synth.snapshot_dir(cache, SC_ID)
        t0 = time.perf_counter()
        synth.write_silentcipher(snap, scp, scfg)
        ws = time.perf_counter() - t0
        written = {f"{f}:{k}": v for f, sd in
                   synth.export_silentcipher(scp).items()
                   for k, v in sd.items()}

        def sc_reexport(real):
            if real["_sc_cfg"] != scfg:
                raise AssertionError(f"hparams read as {real['_sc_cfg']}")
            return {f"{f}:{k}": v.to(dev) for f, sd in
                    synth.export_silentcipher(real["sc"]).items()
                    for k, v in sd.items()}

        loads[SC_ID] = timed_load(
            SC_ID, _files(snap),
            lambda: spectral._try_load_real_silentcipher(
                spectral.WatermarkConfig(), dev),
            {k: v.to(dev) for k, v in written.items()}, sc_reexport, ws)
        _drop_snapshot(cache, SC_ID)
    finally:
        if saved_env is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_env
        shutil.rmtree(cache, ignore_errors=True)
    return loads, runs


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="the attention kernels' checks only (no backbone, "
                         "no K2, no server); prints no result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is unavailable", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vox_serve_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    marks = [("build", time.perf_counter())]
    for line in kernels.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    decode = {v: check_decode(kernels, v) for v in DECODE_VARIANTS}
    k3 = check_k3(kernels)
    # Orpheus's GQA group of 3 at its served shapes, and G = 7 (4 + 3 heads
    # per decode CTA, 9 or 4 tokens per K3 tile) once each
    check_decode(kernels, "K1", H=24, KH=8, batches=(4, 64))
    check_decode(kernels, "K1", H=28, KH=4, batches=(4,))
    check_k3(kernels, H=24, KH=8, shapes=((168, 4), (1024, 5)))
    check_k3(kernels, H=28, KH=4, shapes=((1024, 5),))
    # CSM-1B's served heads: a GQA group of 4 at head dim 64
    check_decode(kernels, "K1", H=32, KH=8, batches=(4, 64), D=64)
    check_k3(kernels, H=32, KH=8, shapes=((168, 4), (1024, 5)), D=64)
    if args.kernels_only:
        return 0
    marks.append(("attention kernels", time.perf_counter()))
    for kv in ("combined", "int8", "f8_e4m3", "pair"):
        check_backbone(kv)
    check_backbone("combined", heads="orpheus")
    check_backbone("combined", heads="csm")
    marks.append(("backbones", time.perf_counter()))
    k2 = check_k2()
    k2h = check_k2("bfloat16")
    marks.append(("K2", time.perf_counter()))
    check_codec()
    marks.append(("codec", time.perf_counter()))

    # the main path runs in each server's daemon, whose counters start at 0
    # (comparison launches above happened in this process and do not count)
    runs = {}
    for c in RANDOM_RUNS:
        runs[c] = end_to_end(card, c)
        marks.append((f"run {c}", time.perf_counter()))
    _loads, ckpt_runs = checkpoint_phase(card)
    marks.append(("checkpoints, L, M, N", time.perf_counter()))
    runs.update(ckpt_runs)
    log("seconds per phase: " + ", ".join(
        f"{name} {t - prev:.1f}" for (name, t), (_, prev)
        in zip(marks[1:], marks)) + f"; all after the build "
        f"{marks[-1][1] - marks[0][1]:.1f}")
    total = {name: sum(r["launches"][name] for r in runs.values())
             for name in runs["A"]["launches"]}
    a, e = runs["A"], runs["E"]
    ratio = e["frames_per_s"] / a["frames_per_s"]
    log(f"E vs A: {e['frames_per_s']:.1f} / {a['frames_per_s']:.1f} frames/s"
        f" = {ratio:.3f} ({'within' if ratio >= 0.8 else 'NOT within'} 20% "
        f"of A; recorded, not a failure)")
    log(f"F solo-stream TTFA {runs['F']['solo_ttfa_s'] * 1e3:.1f} ms vs A's "
        f"4-stream TTFA median {a['ttfa_median_s'] * 1e3:.1f} ms")
    g = runs["G"]
    log(f"G text-stream TTFA {max(g['text_stream_ttfa']) * 1e3:.1f} ms (the "
        f"later of two) vs its /generate streams' "
        f"{max(g['generate_ttfa']) * 1e3:.1f} ms")

    def quant_worst(key):
        return max(decode["K1q int8"][key], decode["K1q f8_e4m3"][key])

    k1q = {**decode["K1q int8"], "max_abs_err": quant_worst("max_abs_err")}
    print(json.dumps({"kernels": [
        {"name": K1, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/attention.py:246",
         "launches": total[K1], **decode["K1"]},
        {"name": K1Q, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/attention.py:300",
         "launches": total[K1Q], **k1q},
        {"name": K3, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/ragged_prefill.cu",
         "replaces": "vox_serve_tpu/ops/pallas_prefill.py:148",
         "launches": total[K3], **k3},
        {"name": K4, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/pallas_attention.py:290",
         "launches": total[K4], **decode["K4"]},
        {"name": K2, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/resunit.cu",
         "replaces": "vox_serve_tpu/ops/pallas_resunit.py:150",
         "launches": total[K2], **k2},
        {"name": K2H, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/resunit.cu",
         "replaces": "vox_serve_tpu/ops/pallas_resunit.py:150",
         "launches": total[K2H], **k2h},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
