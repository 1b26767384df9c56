"""``requests_per_s`` as a per-layer reading, in the cells where the shared
host paces the rate too unevenly for an end-to-end bound: requests
answered in the traced window over its seconds (host clock)."""


def read(ctx):
    return ctx.window.completed / ctx.window.seconds
