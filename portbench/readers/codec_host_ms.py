"""Host ms a request inside the program's ``pipeline.encode`` and
``pipeline.decode_batch`` stage timers (``obs/hooks``, installed for the
traced window)."""

STAGES = ("pipeline.encode", "pipeline.decode_batch")


def read(ctx):
    if ctx.registry is None:
        return None
    hists = [m for name, labels, m in ctx.registry.collect()
             if name == "stage_seconds" and labels.get("stage") in STAGES]
    if not hists:
        return None
    return sum(h.total for h in hists) / ctx.window.completed * 1e3
