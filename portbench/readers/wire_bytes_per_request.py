"""Mean bytes on the wire a request: container header, fp16 side info and
payload, as the blobs' lengths."""


def read(ctx):
    return ctx.window.wire_bytes / ctx.window.completed
