"""Mean ms from the API's first frame to the scheduler's intake (the
sender thread, ZMQ, the wait for the daemon's round boundary):
``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "intake")
