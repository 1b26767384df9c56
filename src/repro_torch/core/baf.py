"""Back-and-Forth (BaF) prediction, paper §3.3, Fig. 2, eq. (6): the conv
variant and the stream variant.

Counterpart of ``repro/core/baf.py``. The conv variant serves inference
and training (quantization in the loop, ``train/baf_trainer.py``); the
stream variant restores a transformer's hidden stream on the receiving
side of a pod boundary (``distributed/pipeline.py``).

Backward: dequantized selected channels --inverse BN--> pre-BN values
          --4 conv layers (PReLU; the first a x2 transposed conv)-->
          estimate of all Q input channels of the split layer.
Forward:  the frozen split conv (stride 2) + BN --> estimate of all P
          channels.
Consolidation (eq. 6): on the C transmitted channels, clip the estimate
to the bin of the received code. ``consolidate`` here is the plain torch
form; the fused kernel is ``repro_torch/kernels/consolidate.py``.

Stream variant: four dense layers (PReLU on the first three) from the C
dequantized channels to the block's input, the frozen block, then
consolidation through the kernel.
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


# ---------------------------------------------------------------------------
# Stream BaF predictor (transformer hidden streams at a pod boundary)
# ---------------------------------------------------------------------------

class BaFStreamConfig(NamedTuple):
    c: int                      # transmitted channels of the D-dim stream
    d_in: int                   # dim of the backward-prediction target
    hidden: int = 512
    dtype: torch.dtype = torch.float32


class BaFStream(nn.Module):
    """Backward predictor for (B, S, D) streams: c -> hidden (PReLU) ->
    hidden (PReLU) -> hidden (PReLU) -> d_in, dense layers in the JAX
    (in, out) layout, stored in ``cfg.dtype``. No upsampling: a stream
    split is stride 1. The weights are drawn from ``seed`` on the CPU,
    then moved to ``device`` (``None`` = the card)."""

    def __init__(self, cfg: BaFStreamConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.l1 = tnn.Dense(cfg.c, cfg.hidden, gen=gen)
        self.a1 = tnn.PReLU(cfg.hidden)
        self.l2 = tnn.Dense(cfg.hidden, cfg.hidden, gen=gen)
        self.a2 = tnn.PReLU(cfg.hidden)
        self.l3 = tnn.Dense(cfg.hidden, cfg.hidden, gen=gen)
        self.a3 = tnn.PReLU(cfg.hidden)
        self.l4 = tnn.Dense(cfg.hidden, cfg.d_in, gen=gen)
        self.to(device=dev, dtype=cfg.dtype)


def _dense(layer, x: torch.Tensor, dtype) -> torch.Tensor:
    """``nn.dense_apply`` of the reference: weights and input cast to
    ``dtype`` when it is given, the bias to the product's dtype."""
    w = layer.weight
    dtype = dtype or torch.promote_types(x.dtype, w.dtype)
    y = x.to(dtype) @ w.to(dtype)
    return y + layer.bias.to(y.dtype)


def _prelu(act, x: torch.Tensor) -> torch.Tensor:
    return tnn.prelu_apply(act.alpha.to(x.dtype), x)


def baf_stream_backward(baf: BaFStream, z_hat_sel: torch.Tensor, *,
                        dtype=None) -> torch.Tensor:
    """(..., C) dequantized transmitted channels -> (..., d_in)."""
    x = _prelu(baf.a1, _dense(baf.l1, z_hat_sel, dtype))
    x = _prelu(baf.a2, _dense(baf.l2, x, dtype))
    x = _prelu(baf.a3, _dense(baf.l3, x, dtype))
    return _dense(baf.l4, x, dtype)


def baf_stream_predict(baf: BaFStream, forward_fn, sel_idx: torch.Tensor,
                       z_hat_sel: torch.Tensor, *,
                       codes: torch.Tensor | None = None,
                       qp: QuantParams | None = None, dtype=None,
                       order: torch.Tensor | None = None) -> torch.Tensor:
    """Stream BaF: backward predictor -> the frozen block ``forward_fn``
    (the sender's block at the boundary) -> consolidation (eq. 6) of the
    transmitted channels when ``codes`` (..., C) are given, with ``qp``'s
    (C,) side info.

    Consolidation runs through ``consolidate_fused`` on a (1, B·S, D)
    float32 view of the estimate (the plain version on the CPU), with
    ``sel_idx`` (C,) int32 and its channel table ``order``
    (``quantize.channel_order(sel_idx)``, computed here when not given),
    then back to the estimate's dtype."""
    # the kernel module imports this one: import it where it is used
    from repro_torch.kernels.consolidate import consolidate_fused
    x_tilde = baf_stream_backward(baf, z_hat_sel, dtype=dtype)
    z_tilde = forward_fn(x_tilde)
    if codes is None:
        return z_tilde
    if qp is None:
        raise ValueError("consolidation needs the quant params with codes")
    d, c = z_tilde.shape[-1], codes.shape[-1]
    z32 = z_tilde.reshape(1, -1, d).to(torch.float32).contiguous()
    consolidate_fused(z32, codes.reshape(1, -1, c).contiguous(),
                      qp.mins.reshape(1, c), qp.maxs.reshape(1, c), qp.bits,
                      sel_idx, order=order)
    return z32.reshape(z_tilde.shape).to(z_tilde.dtype)
