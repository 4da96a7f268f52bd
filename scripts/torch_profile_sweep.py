#!/usr/bin/env python3
"""Derive the serving profile of a family of the PyTorch port on the card
(the values of ``vox_serve_tpu_torch/profiles.py``), at published widths
from random weights (seed 0), by driving the port's worker and its CUDA
graphs directly, with no HTTP.

    PYTHONPATH=. python3 scripts/torch_profile_sweep.py \
        [--family qwen3 csm orpheus] [--startup]

Per family it prints one JSON line (``{"family": ..., "profile": {...},
"rules": {...}, "measured": {...}}``) after these measurements:

* decode at B in ``BATCHES``: the single-step graph's device ms per replay
  and the fused k-step graph's, both over a pack whose rows attend to a
  mid-stream context (prompt + half the generation budget, distinct
  pages); and the wall ms per frame of ``run_lm_decode`` /
  ``run_lm_decode_multi`` over B live requests at pipeline depth 0 and 2
  (host planning and readback included);
* detokenize at (d, the family's window) in float32 and bfloat16, for
  every d = ceil(B / step) (``step`` frames or tokens a window advances):
  the windows B streams make ready in one decode round, which the online
  scheduler detokenizes in one batch, capped at the detokenize bucket
  covering that demand (device ms per replay of padded windows; the
  codec's cost does not depend on the codes);
* prefill at T in ``PREFILL_T`` over ``max_prefill_requests`` rows;
* then, at the lattice the rules give, a worker with a small pool that
  captures every graph: the free memory after the capture gives the pages.

The rules (each printed beside its value under ``rules``):

* ``codec_dtype``: bfloat16 where its detokenize is below 0.9 of
  float32's at the largest batch measured, else float32 (None);
* ``max_batch_size``: the largest B whose decode and detokenize device
  time alone give each of B streams at least ``MARGIN`` times its real-time
  rate (``RATE``: frames, or for Orpheus tokens, per second), capped by
  the pages at the family's ``max_tokens``. A round of B streams takes one
  decode step and, B / step times in a round (at most once), one
  detokenize of ceil(B / step) windows;
* ``decode_buckets``: from the top down, a lower B joins when its step
  costs at most 0.75 of the smallest bucket already in (padding its rows
  up would cost a third more); 1 always;
* ``pipeline_depth``: 2 where the wall per frame at depth 2 is below 0.95
  of depth 0's at the top bucket, else 0;
* ``fused_decode_steps``: ``FUSED_K`` where its wall per frame at depth 2
  is below 0.95 of single-step's at the top bucket, else 0; then the fused
  buckets are the decode buckets, no k schedule, and ``fused_min_batch``
  is the smallest bucket whose single-step rounds (wall) stop covering the
  frames its streams demand;
* ``prefill_buckets``: the 0.75 rule from 1024 down over the prefill times;
  ``max_prefill_requests`` keeps the generic 8;
* ``detok_buckets``: the 0.75 rule over the detokenize times from the
  top batch's demand ceil(B / step) down: the online scheduler caps a
  round's windows at the bucket covering that demand, and the decode
  lattice (the worker's default) would pad them to a decode bucket;
* ``max_num_pages``: 90% of the memory free after every graph of the
  final lattice is captured, over one page's bytes;
* ``page_size``, ``detok_pipeline_depth``, ``first_chunk_frames``,
  ``kv_reserve_fraction``: the generic values.

``--startup`` instead starts each family's launcher with no flag (so the
profile applies), waits for /health, and reports ready seconds, capture
seconds, graphs and each device's memory from the daemon's stats file.
Needs one card (~4-6 min a family with the build).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vox_serve_tpu_torch.models import load_model
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.utils import cdiv
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

FAMILIES = {"qwen3": "qwen3-tts", "csm": "csm", "orpheus": "orpheus"}
#: what one stream consumes in real time: frames (tokens for Orpheus: 7
#: SNAC tokens per 2048 samples at 24 kHz) per second
RATE = {"qwen3": 12.5, "csm": 12.5, "orpheus": 7 * 24000 / 2048}
#: headroom for prefill and host time
MARGIN = 1.5
BATCHES = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 144, 192, 256)
PREFILL_T = (64, 128, 256, 512, 1024)
FUSED_K = 4
PAGE = 16
PROMPT = "Every stream here speaks one short sentence of text."
#: decode rounds timed per (B, mode), after WARM rounds
ROUNDS, WARM = 12, 3
GENERIC = {"page_size": 16, "detok_pipeline_depth": 1,
           "first_chunk_frames": 0, "kv_reserve_fraction": None,
           "max_prefill_requests": None, "ramp_frames": 0,
           "table_width_buckets": None}


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def lattice(times: dict, top: int, lo: int = 1) -> list[int]:
    """The 0.75 rule: from ``top`` down, a smaller size joins when its time
    is at most 0.75 of the smallest size already in; ``lo`` always."""
    out = [top]
    for b in sorted((b for b in times if lo < b < top), reverse=True):
        if times[b] <= 0.75 * times[out[-1]]:
            out.append(b)
    if lo < top:
        out.append(lo)
    return sorted(out)


def mid_pack(worker: ModelWorker, key: tuple, ctx: int,
             pages: np.ndarray) -> np.ndarray:
    """A decode pack (single or fused) whose B rows sit in slots 0..B-1 and
    attend to ``ctx`` tokens over distinct pages, writing the next token."""
    C = worker.model.n_codebooks
    pack = worker._padded_pack(key)
    B, W = key[1], key[-1]
    per = cdiv(ctx + FUSED_K, PAGE)
    tables = pages[:B * per].reshape(B, per)
    if key[0] == "decode":
        v = worker._decode_pack_views(pack, C)
        gen, pos, pid, off, seq, slot, tab = v[2:]
        pid[:] = tables[:, (ctx - 1) // PAGE]
        off[:] = (ctx - 1) % PAGE
        pos[:] = ctx - 1
    else:
        K = key[2]
        v = worker._multi_pack_views(pack, K, B, C, W)
        pos, pid, off, gen, seq, slot, tab = v[2:]
        for s in range(K):
            t = ctx - 1 + s
            pid[s] = tables[:, t // PAGE]
            off[s] = t % PAGE
            pos[s] = t
    gen[:] = ctx // 2
    seq[:] = ctx
    slot[:] = np.arange(B)
    tab[:, :per] = tables
    return pack


def device_ms(worker: ModelWorker, key: tuple, inputs: tuple) -> float:
    """Stage ``inputs`` into key's graph (one replay) and time its replays
    on them."""
    worker._steps.run(key, *inputs)
    torch.cuda.synchronize()
    return worker._steps.steps[key].probe_ms(10)


def wall_per_frame(worker: ModelWorker, reqs: list, depth: int,
                   k: int) -> float:
    """Host wall ms per frame of decode rounds over live requests at
    pipeline depth ``depth`` (k > 1: fused rounds)."""
    worker.config = dataclasses.replace(worker.config, pipeline_depth=depth)

    def rounds(n):
        for _ in range(n):
            if k > 1:
                worker.run_lm_decode_multi(reqs, k)
            else:
                worker.run_lm_decode(reqs)
        worker.sync()
        torch.cuda.synchronize()

    rounds(WARM)
    t0 = time.perf_counter()
    rounds(ROUNDS)
    return (time.perf_counter() - t0) * 1e3 / (ROUNDS * k)


def prefill_all(worker: ModelWorker, reqs: list) -> None:
    todo = list(reqs)
    while todo:
        worker.run_lm_prefill(todo[:worker.config.max_prefill_requests])
        todo = [r for r in todo if not r.done_lm_prefill]
    worker.sync()


def release() -> None:
    """Return a dropped worker's memory (its graphs hold pools)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def drop_graphs(worker: ModelWorker, keys: list) -> None:
    """Free the graphs of ``keys`` (their pool returns to the card once it
    holds no graph)."""
    for k in keys:
        worker._steps.steps.pop(k, None)
    release()


def sweep(fam: str, model, batches: tuple) -> dict:
    """Time decode, detokenize and prefill (see the module docstring)."""
    interval = model.detokenize_interval
    step = interval - model.detokenize_overlap
    prompt = len(model.preprocess(PROMPT, None).input_tokens)
    ctx = prompt + model.max_tokens // 2
    top = max(batches)
    live = cdiv(prompt + (WARM + ROUNDS) * (2 + FUSED_K) + FUSED_K, PAGE) + 1
    num_pages = top * (cdiv(ctx + FUSED_K, PAGE) + live) + 16
    cfg = WorkerConfig(
        max_batch_size=top, num_pages=num_pages, page_size=PAGE, seed=0,
        warmup=False, pipeline_depth=2, kv_reserve_fraction=0.0,
        decode_buckets_override=tuple(batches),
        fused_decode_steps=FUSED_K, fused_decode_buckets=tuple(batches))
    worker = ModelWorker(model, cfg)
    fake = np.asarray(worker.allocator.alloc(
        top * cdiv(ctx + FUSED_K, PAGE)), np.int32)
    W = next(w for w in worker.table_width_buckets
             if w * PAGE >= ctx + FUSED_K)
    # a round's windows: one detokenize batch (within the frame budget)
    detok_batches = sorted({b for b in (cdiv(B, step) for B in batches)
                            if b * interval <= cfg.detok_frame_budget} | {1})
    m: dict = {"prompt_tokens": prompt, "context": ctx, "width": W,
               "interval": interval, "step": step,
               "detok_frame_budget": cfg.detok_frame_budget,
               "decode_ms": {}, "fused_ms": {}, "wall_ms_depth0": {},
               "wall_ms_depth2": {}, "fused_wall_ms_depth2": {},
               "detok_ms_float32": {}, "detok_ms_bfloat16": {},
               "prefill_ms": {}}
    for B in batches:
        reqs = [Request(request_id=f"{fam}{B}_{i}", prompt=PROMPT)
                for i in range(B)]
        prefill_all(worker, reqs)
        m["wall_ms_depth0"][B] = wall_per_frame(worker, reqs, 0, 1)
        m["wall_ms_depth2"][B] = wall_per_frame(worker, reqs, 2, 1)
        m["fused_wall_ms_depth2"][B] = wall_per_frame(worker, reqs, 2,
                                                      FUSED_K)
        for r in reqs:
            worker.free_kv_cache(r)
        key = ("decode", B, W)
        m["decode_ms"][B] = device_ms(worker, key,
                                      (mid_pack(worker, key, ctx, fake),))
        key = ("decode_multi", B, FUSED_K, W)
        m["fused_ms"][B] = device_ms(worker, key,
                                     (mid_pack(worker, key, ctx, fake),))
        print(f"[{fam}] B={B}: decode {m['decode_ms'][B]:.3f} ms, fused "
              f"k={FUSED_K} {m['fused_ms'][B]:.3f} ms, wall/frame "
              f"{m['wall_ms_depth0'][B]:.3f} / {m['wall_ms_depth2'][B]:.3f}"
              f" / fused {m['fused_wall_ms_depth2'][B]:.3f} ms", flush=True)
        drop_graphs(worker, [k for k in worker._steps.steps
                             if k[0] != "prefill"])
    del worker, fake
    release()
    # detokenize and prefill over a small pool; the bf16 codec last (the
    # worker casts the model's codec: its float32 one is put back)
    saved = (model.codec_params, model.init_decoder_cache)
    for dtype in ("float32", "bfloat16"):
        worker = ModelWorker(model, dataclasses.replace(
            cfg, num_pages=64, pipeline_depth=0, fused_decode_steps=0,
            fused_decode_buckets=(1,), kv_reserve_fraction=1.0,
            codec_dtype=None if dtype == "float32" else dtype))
        for B in detok_batches:
            key = ("detok", B, interval)
            m[f"detok_ms_{dtype}"][B] = worker._steps.probe(key)
            drop_graphs(worker, [key])
        print(f"[{fam}] detokenize {dtype}: " + ", ".join(
            f"B={b} {ms:.3f} ms" for b, ms in m[f"detok_ms_{dtype}"].items()),
            flush=True)
        if dtype == "float32":
            for T in PREFILL_T:
                key = ("prefill", T, cfg.max_prefill_requests)
                m["prefill_ms"][T] = worker._steps.probe(key)
                drop_graphs(worker, [key])
            print(f"[{fam}] prefill: " + ", ".join(
                f"T={t} {ms:.3f} ms" for t, ms in m["prefill_ms"].items()),
                flush=True)
        del worker
        release()
    model.codec_params, model.init_decoder_cache = saved
    return m


def detok_per_round(det: dict, B: int, step: int) -> float:
    """Device ms of detokenizing per decode round of B streams: the
    ceil(B / step) windows that one round makes ready, in one batch, B /
    step times a round (at most once)."""
    d = cdiv(B, step)
    return det[min(b for b in det if b >= d)] * min(1.0, B / step)


def stream_pages(model, prompt: int) -> int:
    """Pages one stream holds at the family's max_tokens with the whole
    generation budget reserved (the generic kv_reserve_fraction 1.0)."""
    return (cdiv(prompt, PAGE)
            + cdiv(max(model.max_tokens - prompt, 0) + 8, PAGE) + 1)


def derive(fam: str, m: dict) -> tuple[dict, dict, int, bool]:
    """The rules of the module docstring that need only the timings:
    (profile so far, rules, the batch by time, whether fused rounds
    pay)."""
    step = m["step"]
    batches = sorted(m["decode_ms"])
    rules: dict = {}
    f32, b16 = m["detok_ms_float32"], m["detok_ms_bfloat16"]
    dtop = max(f32)
    bf16 = b16[dtop] < 0.9 * f32[dtop]
    codec = "bfloat16" if bf16 else None
    rules["codec_dtype"] = (
        f"detok B={dtop}: bf16 {b16[dtop]:.3f} vs f32 {f32[dtop]:.3f} ms "
        "(bf16 if < 0.9x)")
    det = b16 if bf16 else f32
    need = MARGIN * RATE[fam]
    # per frame: one decode step + the share of the windows that decode
    # ``step`` new frames of every stream
    cover = {B: 1e3 / (m["decode_ms"][B] + detok_per_round(det, B, step))
             for B in batches if cdiv(B, step) <= max(det)}
    ok = [B for B, v in cover.items() if v >= need]
    B_time = max(ok) if ok else 1
    rules["max_batch_size"] = (
        f"largest B with 1000/(decode_ms(B) + detok_ms(ceil(B/{step})) x "
        f"min(1, B/{step})) >= {MARGIN} x {RATE[fam]:.2f}/s: {B_time}; "
        "per-stream rate " + ", ".join(f"{B}:{v:.1f}"
                                       for B, v in cover.items()))
    rules["detok_buckets"] = "0.75 rule over " + ", ".join(
        f"{b}:{ms:.3f}" for b, ms in det.items())
    fused_gain = (m["fused_wall_ms_depth2"][B_time]
                  < 0.95 * m["wall_ms_depth2"][B_time])
    depth_gain = (m["wall_ms_depth2"][B_time]
                  < 0.95 * m["wall_ms_depth0"][B_time])
    prof = dict(GENERIC)
    prof["codec_dtype"] = codec
    prof["pipeline_depth"] = 2 if depth_gain else 0
    rules["pipeline_depth"] = (
        f"wall/frame at B={B_time}: depth 2 "
        f"{m['wall_ms_depth2'][B_time]:.3f} vs depth 0 "
        f"{m['wall_ms_depth0'][B_time]:.3f} ms (2 if < 0.95x)")
    rules["fused_decode_steps"] = (
        f"wall/frame at B={B_time}, depth 2: fused k={FUSED_K} "
        f"{m['fused_wall_ms_depth2'][B_time]:.3f} vs single "
        f"{m['wall_ms_depth2'][B_time]:.3f} ms (fused if < 0.95x)")
    prefill = m["prefill_ms"]
    prof["prefill_buckets"] = ",".join(
        map(str, lattice(prefill, max(prefill), min(prefill))))
    rules["prefill_buckets"] = "0.75 rule over " + ", ".join(
        f"T={T}:{ms:.3f}" for T, ms in prefill.items())
    return prof, rules, B_time, fused_gain


def finish_profile(fam: str, m: dict, prof: dict, rules: dict, B: int,
                   fused: bool) -> None:
    """The lattices at batch B and the fused keys."""
    buckets = lattice({b: m["decode_ms"][b] for b in m["decode_ms"]
                       if b <= B}, B)
    prof["max_batch_size"] = B
    prof["decode_buckets"] = ",".join(map(str, buckets))
    rules["decode_buckets"] = "0.75 rule over " + ", ".join(
        f"B={b}:{m['decode_ms'][b]:.3f}" for b in m["decode_ms"] if b <= B)
    det = m["detok_ms_bfloat16" if prof["codec_dtype"]
            else "detok_ms_float32"]
    d = min(b for b in det if b >= cdiv(B, m["step"]))
    prof["detok_buckets"] = ",".join(map(str, lattice(det, d)))
    if fused:
        prof["fused_decode_steps"] = FUSED_K
        prof["fused_decode_buckets"] = prof["decode_buckets"]
        prof["fused_k_schedule"] = None
        need = MARGIN * RATE[fam]
        short = [b for b in buckets
                 if 1e3 / m["wall_ms_depth2"][b] < need]
        prof["fused_min_batch"] = min(short) if short else None
        rules["fused_min_batch"] = (
            "smallest bucket whose single-step wall frames/s per stream < "
            f"{need:.2f}: " + ", ".join(
                f"{b}:{1e3 / m['wall_ms_depth2'][b]:.1f}" for b in buckets))
    else:
        prof.update(fused_decode_steps=0, fused_decode_buckets=None,
                    fused_k_schedule=None, fused_min_batch=None)


def measure_pages(model, prof: dict) -> tuple[int, dict]:
    """Capture every graph of the profile in a worker with a small pool;
    90% of what is then free, over one page's bytes."""
    def buckets(spec):
        return tuple(int(x) for x in spec.split(",")) if spec else None

    cfg = WorkerConfig(
        max_batch_size=prof["max_batch_size"], num_pages=64,
        page_size=prof["page_size"], seed=0, warmup=True,
        pipeline_depth=prof["pipeline_depth"],
        detok_pipeline_depth=prof["detok_pipeline_depth"],
        fused_decode_steps=prof["fused_decode_steps"],
        fused_decode_buckets=buckets(prof["fused_decode_buckets"]) or (1,),
        fused_min_batch=prof["fused_min_batch"],
        decode_buckets_override=buckets(prof["decode_buckets"]),
        detok_buckets_override=buckets(prof["detok_buckets"]),
        prefill_token_buckets=buckets(prof["prefill_buckets"]),
        codec_dtype=prof["codec_dtype"])
    t0 = time.perf_counter()
    worker = ModelWorker(model, cfg)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    free, total = torch.cuda.mem_get_info()
    kv = worker.kv_config
    page_bytes = (kv.num_layers * 2 * kv.num_kv_heads * kv.head_dim
                  * worker.k_pages.element_size() * kv.page_size)
    if not kv.combined:
        page_bytes = (worker.k_pages[0].numel() * 2
                      * worker.k_pages.element_size() // kv.num_pages
                      * kv.num_layers)
    pages = int(0.9 * free // page_bytes) + 64
    info = {"graphs": len(worker._steps.steps), "capture_s": capture_s,
            "free_gb": free / 1e9, "total_gb": total / 1e9,
            "page_bytes": page_bytes,
            "pool_mib": worker._steps.pool_bytes() / 2**20}
    del worker
    release()
    return pages, info


def profile_family(fam: str, batches: tuple) -> dict:
    model = load_model(FAMILIES[fam], device="cuda", seed=0)
    m = sweep(fam, model, batches)
    prof, rules, B, fused = derive(fam, m)
    per_stream = stream_pages(model, m["prompt_tokens"])
    while True:
        finish_profile(fam, m, prof, rules, B, fused)
        pages, info = measure_pages(model, prof)
        cap = [b for b in m["decode_ms"] if b <= B and b * per_stream
               <= pages]
        if max(cap) == B:
            break
        B = max(cap)  # the pages hold fewer streams: a smaller lattice
    prof["max_num_pages"] = pages
    rules["max_num_pages"] = (
        f"0.9 x {info['free_gb']:.2f} GB free after capturing "
        f"{info['graphs']} graphs / {info['page_bytes']} B a page; "
        f"{per_stream} pages a stream at max_tokens {model.max_tokens}: "
        f"{pages // per_stream} streams")
    return {"family": fam, "card": card(), "profile": prof, "rules": rules,
            "measured": m, "startup": info}


def startup(fam: str) -> dict:
    """Start the family's launcher with no profile flag and report its
    start-up from the daemon's stats file."""
    import socket
    import urllib.request

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    stats = Path(tempfile.mkdtemp()) / "stats.json"
    cmd = [sys.executable, "-m", "vox_serve_tpu_torch.launch", "--model",
           FAMILIES[fam], "--host", "127.0.0.1", "--port", str(port),
           "--socket-suffix", f"_sweep{port}", "--stats-file", str(stats)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"{fam}: launcher exited "
                                   f"({proc.returncode})")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.perf_counter() - t0 > 600:
                raise RuntimeError(f"{fam}: not ready in 600 s")
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
    for _ in range(100):
        if stats.exists() and stats.stat().st_size:
            break
        time.sleep(0.1)
    st = json.loads(stats.read_text())
    return {"family": fam, "card": card(), "ready_s": ready_s,
            "capture_s": st["steps"]["capture_s"],
            "graphs": len(st["steps"]["graphs"]),
            "memory_gb": st["memory_gb"],
            "served": {k: st.get(k) for k in (
                "max_batch_size", "num_pages", "decode_buckets",
                "fused_decode_steps", "pipeline_depth", "codec_dtypes")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", nargs="+", default=list(FAMILIES),
                    choices=list(FAMILIES))
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--startup", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card(), flush=True)
    if args.startup:
        for fam in args.family:
            print(json.dumps(startup(fam)), flush=True)
        return
    kernels.build()
    batches = tuple(int(b) for b in args.batches.split(","))
    for fam in args.family:
        print(json.dumps(profile_family(fam, batches)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
