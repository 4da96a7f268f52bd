"""5th percentile over the requests due in the window of audio seconds
received over the seconds from the first PCM byte to the last (below 1 a
listener hears a stall); a failed request counts 0."""

from portbench.stats import percentile, stream_rtf


def read(ctx):
    return percentile([stream_rtf(r, ctx.sample_rate)
                       for r in ctx.window_requests], 5)
