"""The whole step's share of the card's peak: the products of every
convolution and of the dense head that the window's answered requests
needed (the configuration's ``counts``), over the window's seconds (host
clock) times the float32 product peak (``peaks.json``: 165 TFLOP/s, the
3xTF32 rate)."""

FLOPS = {"cloud_closed_loop": ("restore_flops", "cloud_flops"),
         "edge_closed_loop": ("edge_flops",),
         "gateway_serve": ("edge_flops", "restore_flops", "cloud_flops")}


def read(ctx):
    per_request = sum(ctx.cfg["counts"][k]
                      for k in FLOPS[ctx.traffic["kind"]])
    rate = per_request * ctx.window.completed / ctx.window.seconds
    return 100.0 * rate / ctx.peaks["float32_product_flops_per_s"]
