"""Share (%) of the bucket rows the detokenize replays ran that carried no
window: 100 x (1 - "detok.windows" / "detok.rows"), the port's
``phase_stats`` counts over every replay since start-up. A padded row of
the flow costs what a real one does."""


def read(ctx):
    ph = ctx.stats["phase_stats"]
    rows = ph.get("detok.rows", (0.0, 0))[0]
    if not rows:
        return None
    return 100.0 * (1.0 - ph["detok.windows"][0] / rows)
