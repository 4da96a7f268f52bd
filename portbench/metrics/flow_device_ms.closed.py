"""Device ms of the flow (the encoder and the 10 guided Euler steps of the
estimator) per detokenize replay: the port's ``phase_stats`` "detok.flow",
device seconds between the events captured around it in each detokenize
graph, over the replays read."""

from portbench.flow_work import part_ms


def read(ctx):
    return part_ms(ctx, "flow")
