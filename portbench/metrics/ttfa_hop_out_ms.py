"""Mean ms from the first chunk sent to the result socket to the client's
first PCM byte (ZMQ, the API's result thread and stream poll, HTTP):
``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "hop_out")
