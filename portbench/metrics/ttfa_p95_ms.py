"""95th percentile of the time to first audio (ms) of the requests due in
the window (``ttfa_p50_ms``'s samples)."""

from portbench.stats import percentile, ttfa_s


def read(ctx):
    return percentile([ttfa_s(r) for r in ctx.window_requests], 95) * 1e3
