"""Split inference: edge -> quantize/entropy-code -> decode -> BaF restore
-> cloud. Paper Fig. 1, end to end.

Counterpart of ``repro/core/split.py``. The coding configuration lives in
``repro_torch.pipeline`` (``OperatingPoint`` -> ``compile`` ->
``CompressionPlan``); this module holds the device-side restore functions
and ``SplitInferenceEngine``, the one-operating-point wrapper over a plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.baf import baf_conv_predict
from repro_torch.core.quant import QuantParams, dequantize
from repro_torch.device import resolve_device
from repro_torch.kernels.consolidate import consolidate_fused


@dataclass
class SplitStats:
    total_bits: int
    payload_bits: int
    side_info_bits: int
    raw_bits: int            # uncompressed fp32 full-tensor bits (reference)
    entropy_bits: float      # order-0 entropy floor of the code stream
    wire_bits: int = 0       # container bytes * 8, header included

    @property
    def reduction_vs_raw(self) -> float:
        return 1.0 - self.total_bits / self.raw_bits


@torch.no_grad()
def restore_codes(baf, split, sel_idx, codes, mins, maxs, *, bits: int,
                  consolidation: bool = True) -> torch.Tensor:
    """Dequantize + BaF restore in plain torch ops (the ``fused=False`` plan).

    codes (B, H, W, C); mins/maxs broadcastable (B, 1, 1, C) fp16; ``split``
    is the CNN's split ``ConvBN``. Returns z~ (B, H, W, P).
    """
    qp = QuantParams(mins, maxs, bits)
    z_hat_sel = dequantize(codes, qp)
    return baf_conv_predict(baf, split, sel_idx, z_hat_sel,
                            codes=codes if consolidation else None,
                            qp=qp if consolidation else None)


@torch.no_grad()
def restore_codes_fused(baf, split, sel_idx, codes, mins, maxs, *,
                        bits: int, order=None) -> torch.Tensor:
    """Same math as ``restore_codes(consolidation=True)``, with eq. (6) run
    by the consolidate kernel (its plain version for CPU tensors).

    The kernel clips the transmitted channels of the full estimate z~ in
    place, so the ``z~[..., sel_idx]`` gather and the scatter back are part
    of the kernel. ``sel_idx`` is int32 on the device of ``codes``;
    ``order`` is its ``channel_order`` table, computed once by the plan
    (``None``: the kernel's wrapper computes it).
    """
    qp = QuantParams(mins, maxs, bits)
    z_hat_sel = dequantize(codes, qp)
    z_tilde = baf_conv_predict(baf, split, sel_idx, z_hat_sel).contiguous()
    b, h, w, p = z_tilde.shape
    c = codes.shape[-1]
    consolidate_fused(z_tilde.view(b, h * w, p),
                      codes.reshape(b, h * w, c).contiguous(),
                      mins.reshape(b, c).contiguous(),
                      maxs.reshape(b, c).contiguous(), bits, sel_idx,
                      order=order)
    return z_tilde


class SplitInferenceEngine:
    """The paper's mobile/cloud pipeline for the Tier-A CNN at one point.

    Compiles one :class:`repro_torch.pipeline.CompressionPlan` (exposed as
    ``self.plan``) and runs it end to end. ``model`` (the CNN) and ``baf``
    must already live on ``device`` (``None`` = the card).
    """

    def __init__(self, model, baf, sel_idx, *, bits: int = 8,
                 backend: str = "zlib", consolidation: bool = True,
                 device=None):
        from repro_torch import pipeline                 # lazy: avoid cycle
        self.device = resolve_device(device)
        for name, mod in (("model", model), ("baf", baf)):
            dev = next(mod.parameters()).device
            if dev != self.device:
                raise ValueError(f"{name} lives on {dev}, engine runs on "
                                 f"{self.device}")
        self.model = model
        self.baf = baf
        self.op = pipeline.OperatingPoint(c=len(sel_idx), bits=bits,
                                          backend=backend)
        self.spec = pipeline.ModelSpec(sel_idx=sel_idx, params=model,
                                       baf_params=baf)
        self.plan = pipeline.compile(self.op, self.spec, fused=False,
                                     consolidation=consolidation,
                                     device=self.device)

    def encode(self, img):
        """Edge forward + plan encode -> (WireBlob, SplitStats)."""
        z = self.model.edge(self.plan.to_device(img))[1]
        blob = self.plan.encode(z)
        return blob, blob.stats

    def decode_and_infer(self, blob) -> torch.Tensor:
        """Decode + BaF restore + cloud forward -> logits."""
        return self.model.cloud(self.plan.restore(self.plan.decode(blob)))

    def __call__(self, img):
        blob, stats = self.encode(img)
        return self.decode_and_infer(blob), stats
