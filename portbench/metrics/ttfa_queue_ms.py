"""Mean ms from the scheduler's intake to admission (the prefill or cold
chain dispatched): ``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "queue")
