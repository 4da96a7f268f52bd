"""Mean ms from the dispatch of the first PCM's device work to the first
chunk sent to the result socket (the codec replay and its readback):
``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "detok")
