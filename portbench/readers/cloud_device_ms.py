"""Device ms a request of every operation (kernels, copies, memsets)
launched inside the program's ``split.cloud`` stage: the CNN's cloud tail
on the restored tensor. It needs a trace that puts each device operation
down to the host range that launched it (``attribution.Attributed``), and
is None on any other trace or where the program has no such stage."""
from portbench.attribution import device_ms


def read(ctx):
    return device_ms(ctx, "split.cloud")
