"""Requests answered in the window over the window's seconds (host clock)."""


def read(ctx):
    return ctx.window.completed / ctx.window.seconds
