"""K3 (``csrc/ragged_prefill.cu``) against its roofline (%): the least
time for the prompt tokens served in the trace's prefill calls (the larger
of the q/k/v/o bytes and the causal attention FLOPs, padding left out)
over K3's summed device time in those calls."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "k3")
