"""Rows a decode step carries on average: the decode rows the daemon
stepped (its wrapper's counts) over the worker's ``steps.decode_steps``."""


def read(ctx):
    steps = ctx.stats["steps"]["decode_steps"]
    return ctx.counts["decode_rows"] / steps if steps else None
