"""PCM seconds that reached all clients during the window, whichever
request they belong to, over the window's seconds."""

from portbench.stats import audio_in_window


def read(ctx):
    tl = ctx.timeline
    return (audio_in_window(ctx.requests, tl.t0, tl.t1, ctx.sample_rate)
            / (tl.t1 - tl.t0))
