"""Ms per scheduler round that did work spent blocked on the card
(``phase_stats`` "round.wait" seconds over the "round" count)."""

from portbench.lifecycle import round_ms


def read(ctx):
    return round_ms(ctx, "wait")
