"""Device ms a request of every kernel that is not one of the port's own
(``src/repro_torch/csrc/*.cu``): cuDNN's convolutions, BN, activations and
the other library kernels of the CNN and BaF models; copies and memsets
left out. From the device trace."""
from portbench.trace import base_name, is_copy


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    own = set().union(*ctx.kernels.values()) if ctx.kernels else set()
    ns = sum(b - a for name, a, b in ctx.trace.ops
             if not is_copy(name) and base_name(name) not in own)
    return ns / 1e6 / ctx.window.completed
