"""Share (%) of the card's bf16 peak that the decode steps in the trace
reach: the model FLOPs of the rows they served (the family reference's
``decode_flops`` from each step's rows and the KV positions they read) over
the device time of the kernels launched inside those steps."""

from portbench.readers import step_share


def read(ctx):
    return step_share(ctx, "decode")
