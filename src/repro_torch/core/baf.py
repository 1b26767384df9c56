"""Back-and-Forth (BaF) prediction, paper §3.3, Fig. 2, eq. (6), conv variant.

Counterpart of the conv half of ``repro/core/baf.py``, for inference and
for training (quantization in the loop, ``train/baf_trainer.py``).

Backward: dequantized selected channels --inverse BN--> pre-BN values
          --4 conv layers (PReLU; the first a x2 transposed conv)-->
          estimate of all Q input channels of the split layer.
Forward:  the frozen split conv (stride 2) + BN --> estimate of all P
          channels.
Consolidation (eq. 6): on the C transmitted channels, clip the estimate
to the bin of the received code. ``consolidate`` here is the plain torch
form; the fused kernel is ``repro_torch/kernels/consolidate.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.core.quant import QuantParams, bin_bounds
from repro_torch.device import resolve_device


def consolidate(z_tilde_sel: torch.Tensor, codes: torch.Tensor,
                qp: QuantParams) -> torch.Tensor:
    """Eq. (6): ``clip(z~, bin_lo, bin_hi)`` on the transmitted channels."""
    lo, hi = bin_bounds(codes, qp)
    out = torch.minimum(torch.maximum(z_tilde_sel.float(), lo), hi)
    return out.to(z_tilde_sel.dtype)


def scatter_consolidated(z_tilde: torch.Tensor, consolidated: torch.Tensor,
                         sel_idx: torch.Tensor) -> torch.Tensor:
    """Write the consolidated channels back into ``z_tilde``, in place."""
    z_tilde[..., sel_idx] = consolidated.to(z_tilde.dtype)
    return z_tilde


def gather_bn(bn: dict, sel_idx: torch.Tensor) -> dict:
    """Per-channel BN parameters restricted to the selected channels."""
    return {k: v[sel_idx] for k, v in bn.items()}


class BaFConvConfig(NamedTuple):
    c: int            # transmitted channels
    q: int            # input channels of the split layer
    hidden: int = 64  # width of the deconv net


class BaFConv(nn.Module):
    """4 conv layers, 3x3, PReLU except on the last (Fig. 2)."""

    def __init__(self, cfg: BaFConvConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.up = tnn.Conv2d(cfg.c, cfg.hidden, 3, gen=gen)
        self.up_act = tnn.PReLU(cfg.hidden)
        self.c2 = tnn.Conv2d(cfg.hidden, cfg.hidden, 3, gen=gen)
        self.c2_act = tnn.PReLU(cfg.hidden)
        self.c3 = tnn.Conv2d(cfg.hidden, cfg.hidden, 3, gen=gen)
        self.c3_act = tnn.PReLU(cfg.hidden)
        self.c4 = tnn.Conv2d(cfg.hidden, cfg.q, 3, gen=gen)
        self.to(dev)

    def backward_predict(self, z_hat_sel: torch.Tensor,
                         bn_sel: dict) -> torch.Tensor:
        """(B, H, W, C) -> (B, 2H, 2W, Q), starting with inverse BN."""
        x = tnn.batchnorm_inverse(bn_sel, z_hat_sel)
        x = self.up_act(self.up.transpose(x, 2))
        x = self.c2_act(self.c2(x))
        x = self.c3_act(self.c3(x))
        return self.c4(x)


def baf_conv_predict(baf: BaFConv, split, sel_idx: torch.Tensor,
                     z_hat_sel: torch.Tensor, *,
                     codes: torch.Tensor | None = None,
                     qp: QuantParams | None = None) -> torch.Tensor:
    """Backward + forward, then consolidation when ``codes`` are given.

    ``split`` is the CNN's frozen split ``ConvBN`` (stride 2): the forward
    predictor. Gradients flow to the BaF weights that require them, through
    the frozen split layer; training calls this without ``codes``
    (consolidation is ignored in training, paper §4). The served path's
    callers (``core/split.py``) run it under ``torch.no_grad()``.
    """
    bn_sel = gather_bn(split.bn.params(), sel_idx)
    x_tilde = baf.backward_predict(z_hat_sel, bn_sel)
    z_tilde = split(x_tilde, 2)
    if codes is not None:
        if qp is None:
            raise ValueError("consolidation needs the quant params with codes")
        cons = consolidate(z_tilde[..., sel_idx], codes, qp)
        z_tilde = scatter_consolidated(z_tilde, cons, sel_idx)
    return z_tilde
