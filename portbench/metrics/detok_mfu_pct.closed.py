"""Share (%) of the card's bf16 peak that the detokenize calls in the
trace reach: the model FLOPs of the windows they decoded (``flow_work.py``:
the flow and HiFT of one window, at the mean over the window lengths the
completed requests in the daemon's stats file list; a call's windows are
its requests, one row each) over the device time of the kernels launched
inside those calls."""

from portbench.flow_work import detok_share


def read(ctx):
    return detok_share(ctx)
