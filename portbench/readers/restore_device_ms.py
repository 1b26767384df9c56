"""Device ms a request of every operation (kernels, copies, memsets)
launched inside the program's ``pipeline.restore`` stage, its child stages
included: the codes' three host-to-device copies, the BaF net and the
consolidate kernel. It needs a trace that puts each device operation down
to the host range that launched it (``attribution.Attributed``), and is
None on any other trace or where the program has no such stage."""
from portbench.attribution import device_ms


def read(ctx):
    return device_ms(ctx, "pipeline.restore")
