"""The TF32 control of a cell whose detokenizer is stated in float32, on
the card:

    python3 -m portbench.control_tf32 --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--fp8]

``control.py``'s flow: for each seed one served run of the cell at its own
load (a short window, long enough to finish its longest requests), then
the run's numbers against the float32 reference (the program's own
readings), and the same prompts and served tokens judged with the
reference's ``prec`` set to TF32 (``reference/tf32.py``): its PCM against
the float32 reference's (``tf32_pcm_rmse``, the lower end of the
``pcm_rmse`` limit's room) and the gap of the token it puts first
(``tf32_lm_gap``). ``--fp8`` also judges them with the float8 control
(``fp8_*``), the step below the LM's bf16. One JSON line per seed; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch

from portbench import spec
from portbench.reference.tf32 import TF32
from portbench.run import (decide, device_info, judge, log, sample_items,
                           serve_once)


def controls(fam, model: dict, seed: int, ref, fp8: bool) -> dict:
    """name -> control reference: the float32 reference with TF32
    operands (its weights shared), and the float8 one."""
    tf32 = copy.copy(ref)
    tf32.prec = TF32()
    out = {"tf32": tf32}
    if fp8:
        out["fp8"] = fam.make_reference(model, seed, "cuda", "fp8")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fp8", action="store_true")
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root, False)
    conf = cell.config
    device_info(cell.chips)
    fam = spec.reference(conf["family"])
    for seed in (int(s) for s in args.seeds.split(",")):
        sv = serve_once(root, cell, seed, args.seconds, False)
        items = sample_items(cell, seed, sv.sender, sv.records)
        ref = fam.make_reference(conf["model"], seed, "cuda")
        numbers = judge(items, ref)
        for name, ctl in controls(fam, conf["model"], seed, ref,
                                  args.fp8).items():
            got = judge(items, ref, ctl)
            numbers[f"{name}_pcm_rmse"] = got["ctl_pcm_rmse"]
            numbers[f"{name}_lm_gap"] = got["ctl_lm_gap"]
        del ref
        torch.cuda.empty_cache()  # the next seed's daemon needs the card
        correct, _ = decide(numbers, conf["check"]["limits"], len(sv.failed))
        out = {"seed": seed, "correct": correct,
               "attempted": len(sv.sender.window_requests()),
               "failed": len(sv.failed), "frames":
               sum(i["audio_tokens"] for i in items), **numbers}
        log(json.dumps(out))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
