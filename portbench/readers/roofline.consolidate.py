"""The consolidate kernel's share of its bound: the bytes of a call at the
cell's shapes (one micro-batch of the traffic's ``batch`` a call) over the
HBM rate, against its mean device time a call from the trace."""
from portbench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.kernel_calls(ctx.kernels.get("consolidate", set()))
    if not calls:
        return None
    cfg = ctx.cfg
    r = cfg["split_shape"][0] * cfg["split_shape"][1]
    bound = counts.consolidate_bytes(ctx.traffic["batch"], r, cfg["c"],
                                     cfg["bits"]) / \
        ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (sum(calls) / len(calls))
