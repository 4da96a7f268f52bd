"""K1 (``csrc/paged_decode.cu``) against its roofline (%): the least time
for the KV bytes the decode steps in the trace had to read (every key and
value of each row's context once, each query and output once) over K1's
summed device time in those steps."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "k1")
