"""Host wall ms of a detokenize call (the worker's ``phase_stats``
"detokenize": window planning, the flow and HiFT graph replays, the
pipelined audio readback)."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("detokenize",), "detokenize")
