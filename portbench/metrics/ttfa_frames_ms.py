"""Mean ms from admission to the dispatch of the device work of the first
PCM (prefill, then decode rounds until the first window's frames exist):
``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "frames")
