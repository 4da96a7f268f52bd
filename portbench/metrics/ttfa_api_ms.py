"""Mean ms from a request's send to the API server's first frame (aiohttp,
the form parse, building the frame): ``portbench/lifecycle.py``."""

from portbench.lifecycle import ttfa_part_ms


def read(ctx):
    return ttfa_part_ms(ctx, "api")
