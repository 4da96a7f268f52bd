"""Seconds from the launcher's start to the first 200 of GET /health:
the daemon's model build, kernel load, graph capture and warm-up."""


def read(ctx):
    return ctx.setup_s
