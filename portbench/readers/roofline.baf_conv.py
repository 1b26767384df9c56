"""The restore's conv kernel's share of its bound: one restore's products
(the configuration's ``restore_flops`` for a micro-batch of the traffic's
``batch``) at the float32 product peak (3xTF32, ``peaks.json``), against
the device time of the ``baf_conv`` kernel's calls over the trace divided
by the number of restores, counted as the consolidate kernel's calls (one
a restore). None where the kernel made no call."""


def read(ctx):
    if ctx.trace is None:
        return None
    convs = ctx.trace.kernel_calls(ctx.kernels.get("baf_conv", set()))
    restores = ctx.trace.kernel_calls(ctx.kernels.get("consolidate", set()))
    if not convs or not restores:
        return None
    bound = ctx.cfg["counts"]["restore_flops"] * ctx.traffic["batch"] / \
        ctx.peaks["float32_product_flops_per_s"]
    return 100.0 * bound / (sum(convs) / len(restores))
