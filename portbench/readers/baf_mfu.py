"""The whole step's share of the card's peak: the products that the
window's answered requests needed, a request's as the cell's family counts
them (``request_flops``: for cnn_baf every convolution and the dense head,
from the configuration's ``counts``), over the window's seconds (host
clock) times the family's product peak (``PRODUCT_PEAK`` in
``peaks.json``; cnn_baf's is 165 TFLOP/s, the float32 3xTF32 rate)."""


def read(ctx):
    per_request = ctx.family.request_flops(ctx.cfg, ctx.traffic["kind"])
    rate = per_request * ctx.window.completed / ctx.window.seconds
    return 100.0 * rate / ctx.peaks[ctx.family.PRODUCT_PEAK]
