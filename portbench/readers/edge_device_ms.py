"""Device ms a request of every operation (kernels, copies, memsets)
launched inside the program's ``split.edge`` stage: the edge CNN at B=1 up
to the split. It needs a trace that puts each device operation down to the
host range that launched it (``attribution.Attributed``), and is None on
any other trace or where the program has no such stage."""
from portbench.attribution import device_ms


def read(ctx):
    return device_ms(ctx, "split.edge")
