"""Host ms per scheduler round that did work: the round's wall time less
its blocking waits on the card (``phase_stats`` "round" less
"round.wait", over the rounds)."""

from portbench.lifecycle import round_ms


def read(ctx):
    return round_ms(ctx, "host")
