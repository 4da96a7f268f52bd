"""Device ms of HiFT (the F0 predictor, the harmonic source, the
upsampling stages and the iSTFT) per detokenize replay: the port's
``phase_stats`` "detok.hift", device seconds between the events captured
around it in each detokenize graph, over the replays read."""

from portbench.flow_work import part_ms


def read(ctx):
    return part_ms(ctx, "hift")
