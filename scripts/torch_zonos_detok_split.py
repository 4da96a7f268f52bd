#!/usr/bin/env python3
"""Split Zonos-v0.1's detokenize on the card into its two parts: DAC 44.1
kHz (the delay reverted, then ``snac_decode`` at the published widths in
float32 with TF32 off, as the worker serves it) and the 44.1 -> 24 kHz
windowed-sinc resample (``sinc_resample``: zero-stuffing by 80, one
``conv1d`` with 3,529 taps at stride 147), each captured in a CUDA graph
and timed by its replays, beside the whole ``detokenize``, at B = 1, 2
and 4 windows of 50 tokens. Prints each part's FLOPs (PyTorch's flop
counter) and the rate they ran at.

    PYTHONPATH=. python3 scripts/torch_zonos_detok_split.py

Random weights (seed 0). Needs one card (~1 min).
"""

from __future__ import annotations

import subprocess

import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke as c
from vox_serve_tpu_torch.codecs.snac import snac_decode
from vox_serve_tpu_torch.models.zonos import N_CB, ZonosLM
from vox_serve_tpu_torch.watermark.silentcipher import sinc_resample


def flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    # as the worker serves the codec: float32 without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    m = ZonosLM(device=dev, seed=0)
    T = m.detokenize_interval
    g = torch.Generator(device=dev).manual_seed(1)
    for B in (1, 2, 4):
        toks = torch.randint(0, 1024, (B, T, N_CB), generator=g, device=dev,
                             dtype=torch.int32)
        codes = [toks[:, k:T - N_CB + k, k] for k in range(N_CB)]
        wav44 = snac_decode(m.codec_params, m.codec_config, codes)
        parts = {
            "detokenize (all of it)": lambda: m.detokenize(
                m.codec_params, toks, None),
            "DAC (snac_decode)": lambda: snac_decode(
                m.codec_params, m.codec_config, codes),
            f"resample 44.1 -> 24 kHz ({wav44.shape[-1]} -> "
            f"{m.output_audio_length} samples a row)": lambda: sinc_resample(
                wav44, 44100, 24000, out_len="ceil"),
        }
        for name, fn in parts.items():
            ms = c.cuda_time_ms(fn, graph=True)
            f = flops(fn)
            print(f"zonos detokenize B={B} window={T}: {name}: {ms:.3f} ms, "
                  f"{f / 1e9:.1f} GFLOP, {f / (ms * 1e-3) / 1e12:.2f} "
                  "TFLOP/s (float32, TF32 off)")


if __name__ == "__main__":
    main()
