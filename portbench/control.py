"""Readings for the limits of ``correct``, on the card:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control] [--fault token|pcm]

For each seed one served run of the cell at its own load (a short window,
long enough to finish its longest requests), then the run's numbers
against the float32 reference: the program's own readings (the lower end
of each limit). ``--control`` also judges the same prompts and served
tokens with the reference in float8 (``reference/common.py``
``Precision``), the step below the configuration's bf16: at each
position the gap of the token the control puts first, and the control's
PCM against the float32 reference's (the upper end). ``--fault`` serves
with the timed path broken (``daemon.py``), and its numbers must fail.
One JSON line per seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from portbench import spec
from portbench.run import (decide, device_info, judge, log, sample_items,
                           serve_once)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=("token", "pcm"), default=None)
    p.add_argument("--detail", action="store_true",
                   help="also one line per judged request: its frames, "
                        "window lengths and numbers")
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root, False)
    conf = cell.config
    device_info(cell.chips)
    fam = spec.reference(conf["family"])
    for seed in (int(s) for s in args.seeds.split(",")):
        sv = serve_once(root, cell, seed, args.seconds, False,
                        {"PORTBENCH_FAULT": args.fault} if args.fault
                        else None)
        items = sample_items(cell, seed, sv.sender, sv.records)
        ref = fam.make_reference(conf["model"], seed, "cuda")
        ctl = (fam.make_reference(conf["model"], seed, "cuda", "fp8")
               if args.control else None)
        numbers = judge(items, ref, ctl)
        if args.detail:  # the look at a number that moves by seed
            for item in items:
                one = judge([item], ref, ctl)
                one.update(frames=item["audio_tokens"], windows=sorted(
                    {w[1] for w in item["windows"]}),
                    pcm_rms=float((item["pcm"].astype("float64") / 32767.0)
                                  .std()) if len(item["pcm"]) else 0.0)
                print(json.dumps({"seed": seed, "request": one}), flush=True)
        del ref, ctl
        torch.cuda.empty_cache()  # the next seed's daemon needs the card
        correct, _ = decide(numbers, conf["check"]["limits"], len(sv.failed))
        out = {"seed": seed, "fault": args.fault, "correct": correct,
               "attempted": len(sv.sender.window_requests()),
               "failed": len(sv.failed), "frames":
               sum(i["audio_tokens"] for i in items), **numbers}
        log(json.dumps(out))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
