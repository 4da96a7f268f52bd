#!/usr/bin/env python3
"""Count the ATen operations one CosyVoice2 detokenize window dispatches
in the PyTorch port (the flow's 10 solver steps over the causal U-Net
estimator, then streaming HiFT), at the published depths and tiny widths:
the count of operations does not depend on the widths, and views and
dtype queries launch no work, so the rest is the number of kernels a
captured detokenize graph holds, give or take the library calls that
launch more than one.

    PYTHONPATH=. python3 scripts/torch_detok_op_count.py [--tokens 28]

Runs on the CPU in a few seconds.
"""

from __future__ import annotations

import argparse
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vox_serve_tpu_torch.codecs.cosyvoice_flow import (CosyFlowConfig,
                                                       init_cosy_flow)
from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig, init_hift
from vox_serve_tpu_torch.models.backbone import seeded_generator
from vox_serve_tpu_torch.models.flow_common import CosyFlowDecodeMixin

#: operations that only describe a tensor or a dtype: no kernel
NO_WORK = {"aten.view", "aten._unsafe_view", "aten.expand", "aten.transpose",
           "aten.t", "aten.permute", "aten.unsqueeze", "aten.squeeze",
           "aten.slice", "aten.select", "aten.as_strided", "aten.alias",
           "aten.detach", "aten.promote_types", "aten.split", "aten.unbind",
           "aten.reshape", "aten.unfold", "aten.view_as_real", "aten.real",
           "aten.imag", "aten.result_type", "aten.lift_fresh"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


class _Codec(CosyFlowDecodeMixin):
    detokenize_overlap = 3

    def __init__(self, flow_cfg, hift_cfg):
        self._flow_cfg, self._hift_cfg = flow_cfg, hift_cfg
        self.device = torch.device("cpu")
        self._noise_generator = torch.Generator().manual_seed(0)
        self._flow_noise = {}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=28,
                    help="window length in tokens (28; catch-up: 53, 103)")
    args = ap.parse_args()
    flow_cfg = CosyFlowConfig(input_size=16, output_size=16, heads=2,
                              linear_units=16, spk_dim=8, mel_dim=8,
                              est_channels=8, est_head_dim=4, est_heads=2)
    hift_cfg = HiFTConfig(in_channels=8, base_channels=16,
                          f0_cond_channels=8)
    g = seeded_generator("cpu", 0)
    params = {"flow": init_cosy_flow(flow_cfg, g, "cpu"),
              "hift": init_hift(hift_cfg, g, "cpu")}
    codec = _Codec(flow_cfg, hift_cfg)
    cache = codec.init_decoder_cache(1)
    tokens = torch.randint(0, 6561, (1, args.tokens, 1))
    codec.detokenize(params, tokens, cache)  # draws the window's noise
    with _Count() as count, torch.no_grad():
        codec.detokenize(params, tokens, cache)
    work = {k: n for k, n in count.ops.items() if k not in NO_WORK}
    print(f"{args.tokens}-token window: {sum(count.ops.values())} ATen "
          f"operations, {sum(work.values())} of them launch work")
    for name, n in sorted(work.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {name}: {n}")


if __name__ == "__main__":
    main()
