"""Seconds from the start of run.py to the window's start: imports, the
kernels' build or load, weights, frames, the clients' blobs and one warm
round of the cell's traffic."""


def read(ctx):
    return ctx.setup_s
