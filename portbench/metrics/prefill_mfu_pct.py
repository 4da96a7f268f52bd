"""Share (%) of the card's bf16 peak that the prefill calls in the trace
reach: the model FLOPs of the prompt tokens they served (not the bucket's
padding; the family reference's ``prefill_flops``) over the device time of
the kernels launched inside those calls."""

from portbench.readers import step_share


def read(ctx):
    return step_share(ctx, "prefill")
