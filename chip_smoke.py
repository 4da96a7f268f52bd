#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vox_serve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build: compiles the port's CUDA kernels (csrc/*.cu, sm_90a) with nvcc.
3. K1 paged decode attention vs its plain PyTorch version at Qwen3-TTS-1.7B
   talker shapes (B in {1, 8, 64}, H=16, KH=8, D=128, page 16, 28 layers,
   4096 pages so pool offsets pass 2^31), random non-contiguous block
   tables, seq_lens up to ~1000 and one padded row; CUDA-event times of
   both.
4. K3 ragged prefill attention vs its plain version at T in {64, 256, 1024}
   with 1-5 ragged segments (valid rows compared); CUDA-event times.
   Then a small-width talker backbone (prefill + 3 decode steps over the
   paged pool) on the card through both kernels, against the same weights
   on the CPU in float32 through the plain versions.
5. end to end over HTTP: ``python -m vox_serve_tpu_torch.launch --model
   qwen3-tts --device cuda`` serves Qwen3-TTS-12Hz-1.7B-CustomVoice at full
   width (28x2048 talker, 5x1024 depth, default codec; random weights from a
   seed) and 4 concurrent streaming /generate requests of ~60 frames must
   return non-empty PCM16. The scheduler daemon zeroes its kernel launch
   counters before its loop starts (nothing has launched a kernel in it
   yet) and writes them out when terminated; K1 and K3 must both have run.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
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
BACKBONE_REL_TOL = 5e-2  # bf16 weights/activations vs the f32 CPU run


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_times(plain, kernel) -> tuple[float, float]:
    """plain, kernel, kernel, plain; mean of the two runs of each."""
    p1 = cuda_time_ms(plain)
    k1 = cuda_time_ms(kernel)
    k2 = cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------


def check_k1(kernels) -> dict:
    import torch

    dev = torch.device("cuda")
    L, P, page, H, KH, D = 28, 4096, 16, 16, 8, 128
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    pool = torch.empty((L, P, page, 2 * KH, D), dtype=torch.bfloat16,
                       device=dev)
    pool.normal_(generator=g)
    layer = L - 1  # the far end of the pool: offsets past 2^31 elements
    worst, res = 0.0, {}
    rng = torch.Generator().manual_seed(2)
    for B in (1, 8, 64):
        seq = torch.randint(1, 1001, (B,), generator=rng)
        if B > 1:
            seq[B // 2] = 1  # padded row: seq_len 1 on scratch page 0
        maxp = int((seq.max() + page - 1) // page)
        perm = torch.randperm(P - 1, generator=rng)[: B * maxp] + 1
        tables = perm.reshape(B, maxp).to(torch.int32)
        if B > 1:
            tables[B // 2] = 0
        q = torch.randn((B, H, D), generator=rng).to(torch.bfloat16)
        q, tables, seq = q.to(dev), tables.to(dev), seq.to(torch.int32).to(dev)
        out = kernels.paged_decode_attention(q, pool, layer, tables, seq)
        ref = kernels.paged_decode_attention_plain(q, pool, layer, tables, seq)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > K1_TOL:
            raise AssertionError(f"K1 B={B}: max_abs_err {err} > {K1_TOL}")
        ms, plain_ms = alternate_times(
            lambda: kernels.paged_decode_attention_plain(q, pool, layer,
                                                         tables, seq),
            lambda: kernels.paged_decode_attention(q, pool, layer, tables,
                                                   seq))
        worst = max(worst, err)
        # bytes the kernel must read: every live token's K and V rows
        gbs = int(seq.sum()) * 2 * KH * D * 2 / (ms * 1e-3) / 1e9
        log(f"K1 paged_decode_attention B={B} max_seq={int(seq.max())} "
            f"tokens={int(seq.sum())} max_abs_err={err:.3e} (tol {K1_TOL}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"kv_read_GB/s={gbs:.0f}")
        res = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    del pool
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: K3 and the small backbone
# ---------------------------------------------------------------------------


def check_k3(kernels) -> dict:
    import torch

    dev = torch.device("cuda")
    H, KH, D = 16, 8, 128
    rng = torch.Generator().manual_seed(3)
    worst, res = 0.0, {}
    for T, nseg in ((64, 1), (256, 3), (1024, 5)):
        # nseg random positive spans, then a padded tail (seg -1)
        valid = T - int(torch.randint(0, T // 8 + 1, (1,), generator=rng))
        cuts = sorted((torch.randperm(valid - 1, generator=rng)[: nseg - 1]
                       + 1).tolist())
        lens = [b - a for a, b in zip([0] + cuts, cuts + [valid])]
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
            lambda: kernels.ragged_prefill_attention(q, k, v, seg))
        worst = max(worst, err)
        # causal pairs x (QK^T + PV) x heads x head dim
        flops = sum(n * (n + 1) // 2 for n in lens) * 4 * H * D
        log(f"K3 ragged_prefill_attention T={T} segments={lens} "
            f"valid={int(valid.sum())} max_abs_err={err:.3e} (tol {K3_TOL}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"TFLOP/s={flops / (ms * 1e-3) / 1e12:.2f}")
        res = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    return res


def check_backbone() -> None:
    """Small talker backbone: card (bf16, kernels) vs CPU (f32, plain)."""
    import torch

    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     backbone_forward,
                                                     init_backbone_params)
    from vox_serve_tpu_torch.ops.attention import AttnMetadata
    from vox_serve_tpu_torch.params import tree_to_torch

    cfg = BackboneConfig(vocab_size=64, hidden_size=256, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=128,
                         intermediate_size=512, qk_norm=True,
                         rope_theta=1e6, dtype=torch.float32)
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
        pool = torch.zeros((2, P, page, 4, 128), dtype=dtype, device=device)
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
                                 pool)]
        for s, x in enumerate(xs):
            cur = torch.tensor([n + s for n in lens])
            meta = AttnMetadata(
                False, t(torch.tensor([pages[i][int(cur[i]) // page]
                                       for i in range(len(lens))])),
                t(cur % page), block_tables=t(torch.tensor(pages)),
                seq_lens=t(cur + 1))
            outs.append(backbone_forward(p, c, x.to(device, dtype), t(cur),
                                         meta, pool))
        return [o.float().cpu() for o in outs]

    ref = run("cpu", torch.float32)
    got = run("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, ref))
    if rel > BACKBONE_REL_TOL:
        raise AssertionError(f"backbone on card vs CPU: rel err {rel}")
    log(f"backbone (2x256, prefill {list(lens)} + 3 decode steps) card bf16 "
        f"kernels vs CPU f32 plain: max rel err {rel:.3e} "
        f"(tol {BACKBONE_REL_TOL})")


# ---------------------------------------------------------------------------
# phase 5: end to end over HTTP
# ---------------------------------------------------------------------------

PROMPTS = [
    "Streaming speech from the port.",
    "Four requests share one batch..",
    "Every frame runs both kernels!!",
    "The codec turns codes to audio.",
]
MAX_TOKENS = 100  # absolute positions: 42-token prompts -> ~60 frames
SAMPLES_PER_FRAME = 1920
SAMPLE_RATE = 24000


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


def stream_generate(port: int, text: str, out: dict) -> None:
    body = urllib.parse.urlencode({"text": text, "speaker": "ryan",
                                   "language": "english"})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=body, headers={
            "Content-Type": "application/x-www-form-urlencoded"})
        resp = conn.getresponse()
        out["status"] = resp.status
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


def end_to_end(card: str) -> dict:
    import numpy as np

    OUT.mkdir(exist_ok=True)
    port = free_port()
    stats_path = OUT / "chip_smoke_server_stats.json"
    if stats_path.exists():
        stats_path.unlink()
    server_log = open(OUT / "chip_smoke_server.log", "w")
    cmd = [sys.executable, "-m", "vox_serve_tpu_torch.launch",
           "--model", "qwen3-tts", "--device", "cuda",
           "--host", "127.0.0.1", "--port", str(port),
           "--max-batch-size", "4", "--max-num-pages", "2048",
           "--max-tokens", str(MAX_TOKENS), "--seed", "0",
           "--socket-suffix", f"_smoke{port}",
           "--stats-file", str(stats_path)]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=server_log,
                            stderr=subprocess.STDOUT, start_new_session=True)
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
        log(f"server ready in {time.perf_counter() - t_start:.1f} s")

        results = [{} for _ in PROMPTS]
        threads = [threading.Thread(target=stream_generate,
                                    args=(port, p, r))
                   for p, r in zip(PROMPTS, results)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        frames = 0
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
            if pcm.size > MAX_TOKENS * SAMPLES_PER_FRAME:
                raise AssertionError(f"request {i}: {pcm.size} samples > "
                                     "the frame budget")
            if not np.isfinite(pcm.astype(np.float32)).all():
                raise AssertionError(f"request {i}: non-finite PCM")
            r["frames"] = pcm.size / SAMPLES_PER_FRAME
            frames += r["frames"]
            log(f"request {i}: {pcm.size} samples ({r['frames']:.1f} frames,"
                f" {pcm.size / SAMPLE_RATE:.2f} s audio, peak "
                f"{int(np.abs(pcm.astype(np.int32)).max())}), TTFA "
                f"{r['ttfa_s'] * 1e3:.1f} ms, wall {r['wall_s']:.2f} s")
    except Exception:
        server_log.flush()
        tail = (OUT / "chip_smoke_server.log").read_text().splitlines()[-80:]
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
    ttfa = sorted(r["ttfa_s"] for r in results)
    ph = stats["phase_stats"]
    dec_t, dec_n = ph.get("decode", (0.0, 0))
    log(f"e2e on {card}: 4 streams, {frames:.1f} frames in {wall:.2f} s = "
        f"{frames / wall:.1f} frames/s aggregate; TTFA min/median/max "
        f"{ttfa[0] * 1e3:.1f}/{(ttfa[1] + ttfa[2]) / 2 * 1e3:.1f}/"
        f"{ttfa[-1] * 1e3:.1f} ms; mean decode step "
        f"{dec_t / max(dec_n, 1) * 1e3:.2f} ms over {dec_n} steps; "
        f"params LM {stats['param_count']['lm'] / 1e9:.3f} B + codec "
        f"{stats['param_count']['codec'] / 1e6:.1f} M")
    log(f"kernel launches during the e2e run: {stats['launches']}")
    for name, n in stats["launches"].items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return stats["launches"]


def main() -> int:
    import torch

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
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k1 = check_k1(kernels)
    k3 = check_k3(kernels)
    check_backbone()

    # the main path runs in the server's daemon, whose counters start at 0
    # (comparison launches above happened in this process and do not count)
    launches = end_to_end(card)

    print(json.dumps({"kernels": [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/attention.py:246",
         "launches": launches["paged_decode_attention"], **k1},
        {"name": "ragged_prefill_attention", "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/ragged_prefill.cu",
         "replaces": "vox_serve_tpu/ops/pallas_prefill.py:148",
         "launches": launches["ragged_prefill_attention"], **k3},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
