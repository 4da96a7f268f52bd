"""Median time to first audio (ms) of the requests due in the window: from
a request's due time (open loop: its scheduled send time; closed loop: its
send) to its first PCM byte; a failed request counts as infinitely late."""

from portbench.stats import percentile, ttfa_s


def read(ctx):
    return percentile([ttfa_s(r) for r in ctx.window_requests], 50) * 1e3
