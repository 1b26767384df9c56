"""Split inference: edge -> quantize/entropy-code -> decode -> BaF restore
-> cloud. Paper Fig. 1, end to end.

Counterpart of ``repro/core/split.py``. The coding configuration lives in
``repro_torch.pipeline`` (``OperatingPoint`` -> ``compile`` ->
``CompressionPlan``); this module holds the device-side restore functions,
the fidelity metrics the rate controller's RD sweep reads, and
``SplitInferenceEngine``, the one-operating-point wrapper over a plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import nn as tnn
from repro_torch.core.baf import baf_conv_predict
from repro_torch.core.quant import (QuantParams, compute_quant_params,
                                    dequantize, quantize)
from repro_torch.device import resolve_device
from repro_torch.kernels.consolidate import consolidate_fused


@dataclass(frozen=True)
class ActivationStats:
    """Cheap per-request content descriptor of the selected split channels.

    The quantizer step scales with the content's dynamic range and the PSNR
    peak follows the content's peak, so these two numbers are enough for the
    rate controller to shift calibration-time RD-table PSNRs toward *this*
    request (``serve/rate_control.py`` ``ContentKeyedController``).
    """
    peak: float          # max |z_sel| over the example
    dyn_range: float     # mean over channels of per-channel (max - min)


def activation_stats(z, sel_idx) -> ActivationStats:
    """O(HWC) statistics of ``z[..., sel_idx]`` on the host, in numpy as the
    JAX package computes them. z: (B, H, W, P) numpy or tensor (copied to
    the host); stats are aggregated over the whole array."""
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    z_sel = np.asarray(z)[..., np.asarray(sel_idx)]
    flat = z_sel.reshape(-1, z_sel.shape[-1]).astype(np.float32)
    peak = float(np.max(np.abs(flat))) if flat.size else 0.0
    rng = float(np.mean(np.max(flat, 0) - np.min(flat, 0))) if flat.size else 0.0
    return ActivationStats(peak=peak, dyn_range=rng)


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


def check_device(device: torch.device, **modules) -> None:
    """Raise unless every module's weights live on ``device``."""
    for name, mod in modules.items():
        dev = next(mod.parameters()).device
        if dev != device:
            raise ValueError(f"{name} lives on {dev}, the caller runs on "
                             f"{device}")


def to_device(x, device) -> torch.Tensor:
    """A numpy array (copied) or tensor as float32 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device, torch.float32)


def cnn_fns(model):
    """The CNN's halves as the serving path calls them, bound once:
    ``edge(img) -> z`` and ``cloud(z) -> logits`` (the counterpart of the JAX
    package's cached jitted pair; no compilation here)."""
    return (lambda img: model.edge(img)[1]), model.cloud


@torch.no_grad()
def fidelity_metrics(model, baf, sel_idx, img, *, bits: int,
                     consolidation: bool = True, z=None, device=None):
    """Continuous restoration metrics at one (C, bits) operating point.

    (psnr_db of leaky(z~) against leaky(z), mean KL(cloud || split) of the
    downstream logits), computed as ``repro.core.split.fidelity_metrics``
    does: per-example side info, the plain quantizer and the ``fused=False``
    restore, in float32 on ``device`` (``None`` = the card), where ``model``
    and ``baf`` must live. ``img`` (B, H, W, 3) and ``z`` (a precomputed
    split activation that skips the edge forward) may be numpy or tensors.
    """
    dev = resolve_device(device)
    check_device(dev, model=model, baf=baf)
    edge, cloud = cnn_fns(model)
    sel = torch.as_tensor(np.asarray(sel_idx, np.int32), device=dev)
    if z is None:
        z = edge(to_device(img, dev))
    else:
        z = to_device(z, dev)
    z_sel = z[..., sel.long()]
    qp = compute_quant_params(z_sel, bits, per_example=True)
    z_tilde = restore_codes(baf, model.split, sel, quantize(z_sel, qp),
                            qp.mins, qp.maxs, bits=bits,
                            consolidation=consolidation)
    y_true = tnn.leaky_relu(z).float()
    y_rest = tnn.leaky_relu(z_tilde).float()
    mse = float(torch.mean(torch.square(y_true - y_rest)))
    peak = float(torch.max(torch.abs(y_true))) or 1.0
    psnr = 10.0 * np.log10(peak * peak / max(mse, 1e-12))
    p_cloud = torch.log_softmax(cloud(z).float(), dim=-1)
    p_split = torch.log_softmax(cloud(z_tilde).float(), dim=-1)
    kl = float(torch.mean(torch.sum(torch.exp(p_cloud)
                                    * (p_cloud - p_split), -1)))
    return psnr, kl


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
        check_device(self.device, model=model, baf=baf)
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

    def fidelity(self, img):
        """Continuous restoration metrics; see :func:`fidelity_metrics`."""
        return fidelity_metrics(self.model, self.baf, self.spec.sel_idx, img,
                                bits=self.op.bits,
                                consolidation=self.plan.consolidation,
                                device=self.device)

    def __call__(self, img):
        blob, stats = self.encode(img)
        return self.decode_and_infer(blob), stats
