"""Prompts a prefill call carries on average: the rows the daemon's
prefill dispatches took over its prefill calls (the daemon wrapper's
counts), over all traffic served since the daemon's counters were
zeroed."""


def read(ctx):
    c = ctx.counts
    return c["prefill_rows"] / c["prefill_calls"] if c["prefill_calls"] \
        else None
