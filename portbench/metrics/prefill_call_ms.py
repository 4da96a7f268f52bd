"""Host wall ms of a prefill call (the worker's ``phase_stats`` "prefill":
pack, upload, graph replay, readback)."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("prefill",), "prefill")
