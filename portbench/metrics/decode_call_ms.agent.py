"""Host wall ms of a decode call: the worker's ``phase_stats``
"decode.plan" + "decode.dispatch" + "decode.resolve" over its decode
calls."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("decode.plan", "decode.dispatch",
                          "decode.resolve"), "decode.plan")
