"""Host ms a request inside the program's ``split.edge`` stage timer
(``obs/hooks``, installed for the traced window): the host's dispatch of
the edge CNN at B=1, up to the return of its last launch."""


def read(ctx):
    if ctx.registry is None:
        return None
    hists = [m for name, labels, m in ctx.registry.collect()
             if name == "stage_seconds" and labels.get("stage") == "split.edge"]
    if not hists:
        return None
    return sum(h.total for h in hists) / ctx.window.completed * 1e3
