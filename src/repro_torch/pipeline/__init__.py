"""Compression-pipeline API of the port: operating points compiled into
executable plans, as in ``repro.pipeline``.

    from repro_torch import pipeline

    op   = pipeline.OperatingPoint(c=64, bits=8, backend="rans")
    plan = pipeline.compile(op, pipeline.ModelSpec(sel_idx=sel, params=cnn,
                                                   baf_params=baf))
    blob    = plan.encode(z)                 # kernels on the card, host rANS
    decoded = plan.decode_batch([blob, ...]) # vectorized host decode
    z_tilde = plan.restore(decoded)          # BaF restore + consolidation
"""
from repro_torch.pipeline.op import (WIRE_PROFILE_VERSION, Capabilities,
                                     NegotiationError, OperatingPoint,
                                     negotiate)
from repro_torch.pipeline.plan import (CompressionPlan, DecodedBatch,
                                       ModelSpec, WireBlob, blob_from_tensor,
                                       compile)

__all__ = [
    "WIRE_PROFILE_VERSION", "Capabilities", "NegotiationError",
    "OperatingPoint", "negotiate",
    "CompressionPlan", "DecodedBatch", "ModelSpec", "WireBlob",
    "blob_from_tensor", "compile",
]
