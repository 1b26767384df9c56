"""Tier-A training: (1) pretrain the CNN on the detection-proxy task, (2)
offline channel-selection statistics, (3) train the BaF predictor with the
original network FROZEN, the paper's protocol (§4):

  * the BaF net's inputs are the *dequantized quantized* selected channels
    (quantization in the loop, per-example side info);
  * the target is the post-activation tensor Y = sigma(Z) of the split layer;
  * the loss is the Charbonnier penalty (eq. 7), eps = 1e-3;
  * consolidation (eq. 6) is ignored in training;
  * no gradient reaches the original network's weights.

Counterpart of ``repro/train/baf_trainer.py``, with its signatures plus
``device=`` (``None`` = the card). Weights are modules: ``pretrain_cnn``
returns a :class:`CNN`, ``train_baf`` a :class:`BaFConv` in
``BaFTrainResult.baf_params``, both frozen again when they return. A step
computes the gradients of the module's trainable weights with
``torch.autograd.grad`` and writes AdamW's update (``repro_torch.optim``)
into them; in pretraining the BN running stats come from the train-mode
forward, as the reference's ``merge`` keeps them.

Quantization in the loop is the quantize kernel on the card (its plain
version for CPU tensors): ``compute_quant_params(per_example=True)`` +
``quantize`` of ``z[..., sel]`` is what ``quantize_fused`` computes, one
launch a step, with the channel table computed once per ``train_baf``. No
gradient flows through the codes: z comes from the frozen network.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import nn as tnn
from repro_torch.core.baf import BaFConv, BaFConvConfig, baf_conv_predict
from repro_torch.core.losses import charbonnier
from repro_torch.core.quant import QuantParams, dequantize
from repro_torch.core.selection import (SelectionResult,
                                        correlation_matrix_conv,
                                        select_channels)
from repro_torch.data.synthetic import (ShapesDatasetConfig,
                                        shapes_batch_iterator)
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import channel_order, quantize_fused
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_with_warmup)
from repro_torch.optim.adamw import AdamWState


PRETRAIN_ADAMW = AdamWConfig(weight_decay=1e-4)
BAF_ADAMW = AdamWConfig(weight_decay=0.0)   # small predictor; paper uses none


def _device_of(module: torch.nn.Module, device) -> torch.device:
    """``device`` resolved (``None`` = the card); ``module`` must live there."""
    dev = resolve_device(device)
    got = next(module.parameters()).device
    if got != dev:
        raise ValueError(f"the model lives on {got}, the call runs on {dev}")
    return dev


def trainable(module: torch.nn.Module) -> dict:
    """name -> parameter, for the parameters that require gradients."""
    return {n: p for n, p in module.named_parameters() if p.requires_grad}


def apply_adamw(params: dict, grads: dict, opt: AdamWState, lr,
                cfg: AdamWConfig) -> AdamWState:
    """One AdamW step, written into ``params`` in place -> the new state."""
    new, opt, _ = adamw_update(grads, opt, params, lr, cfg)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new[k])
    return opt


# ---------------------------------------------------------------------------
# 1. CNN pretraining (stand-in for darknet COCO weights)
# ---------------------------------------------------------------------------

def cnn_grads(model: CNN, img: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy of the batch-stat forward (every BN's running stats
    take their EMA step) -> (loss, accuracy, name -> gradient of each
    trainable weight)."""
    params = trainable(model)
    logits = model.forward_train(img)
    ll = torch.log_softmax(logits, dim=-1)
    loss = -ll.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), acc, dict(zip(params, grads))


def pretrain_step(model: CNN, opt: AdamWState, lr, img: torch.Tensor,
                  labels: torch.Tensor, cfg: AdamWConfig):
    """One pretraining step of the trainable weights -> (opt, loss, acc)."""
    loss, acc, grads = cnn_grads(model, img, labels)
    return apply_adamw(trainable(model), grads, opt, lr, cfg), loss, acc


def pretrain_cnn(cnn_cfg: CNNConfig, data_cfg: ShapesDatasetConfig, *,
                 steps: int = 400, lr: float = 3e-3, seed: int = 0,
                 log_every: int = 100, verbose: bool = True, device=None):
    """-> (the trained CNN, frozen; [(step, loss, accuracy)] every
    ``log_every`` steps and at the last)."""
    dev = resolve_device(device)
    model = CNN(cnn_cfg, seed=seed, device=dev)
    model.requires_grad_(True)
    opt = adamw_init(trainable(model))
    sched = cosine_with_warmup(lr, steps // 10, steps)
    it = shapes_batch_iterator(data_cfg, seed=seed + 1, device=dev)
    hist = []
    for s in range(steps):
        img, labels = next(it)
        opt, loss, acc = pretrain_step(model, opt, sched(s), img, labels,
                                       PRETRAIN_ADAMW)
        if s % log_every == 0 or s == steps - 1:
            hist.append((s, float(loss), float(acc)))
            if verbose:
                print(f"  [cnn-pretrain] step {s:4d} loss {float(loss):.4f} "
                      f"acc {float(acc):.3f}")
    model.requires_grad_(False)
    return model, hist


def eval_cnn(model: CNN, data_cfg: ShapesDatasetConfig, *, batches: int = 20,
             seed: int = 10_000, device=None) -> float:
    """Mean accuracy of the inference forward over ``batches`` batches."""
    dev = _device_of(model, device)
    it = shapes_batch_iterator(data_cfg, seed=seed, device=dev)
    accs = []
    for _ in range(batches):
        img, labels = next(it)
        accs.append((model(img).argmax(dim=-1) == labels).float().mean())
    return float(torch.stack(accs).double().mean())


# ---------------------------------------------------------------------------
# 2. Offline channel selection (paper: 1k COCO images; here: n batches)
# ---------------------------------------------------------------------------

def compute_channel_order(model: CNN, data_cfg: ShapesDatasetConfig, *,
                          batches: int = 16, seed: int = 999,
                          device=None) -> SelectionResult:
    """Eqs. (2)-(3) over ``batches`` batches of the edge's (x_in, z): the
    mean per-batch correlation matrix, ranked on the host."""
    dev = _device_of(model, device)
    it = shapes_batch_iterator(data_cfg, seed=seed, device=dev)
    acc = None
    for _ in range(batches):
        img, _ = next(it)
        x_in, z = model.edge(img)
        r = correlation_matrix_conv(z, x_in)
        acc = r if acc is None else acc + r
    return select_channels(acc / torch.tensor(float(batches), device=dev))


# ---------------------------------------------------------------------------
# 3. BaF predictor training (frozen original network)
# ---------------------------------------------------------------------------

class BaFTrainResult(NamedTuple):
    baf_params: BaFConv          # the trained predictor, frozen
    sel_idx: np.ndarray
    losses: list                 # [(step, charbonnier)]


def _sel_on(sel_idx, dev: torch.device) -> torch.Tensor:
    """The selection as a contiguous int32 tensor on ``dev``."""
    if isinstance(sel_idx, torch.Tensor):
        return sel_idx.to(dev, torch.int32).contiguous()
    return torch.as_tensor(np.asarray(sel_idx, np.int32), device=dev)


def make_baf_loss(model: CNN, sel_idx, bits: int, *, device=None):
    """Charbonnier loss of sigma(Z~) against sigma(Z), quantization in the
    loop -> ``loss_fn(baf, z)``. The selection's channel table is computed
    here, once."""
    dev = _device_of(model, device)
    sel = _sel_on(sel_idx, dev)
    order = channel_order(sel)
    split = model.split

    def loss_fn(baf: BaFConv, z: torch.Tensor) -> torch.Tensor:
        y_target = tnn.leaky_relu(z)                     # sigma(Z): paper's Y
        b, h, w, p = z.shape
        codes, mins, maxs = quantize_fused(z.contiguous().view(b, h * w, p),
                                           bits, sel, order=order)
        c = sel.numel()
        qp = QuantParams(mins.view(b, 1, 1, c), maxs.view(b, 1, 1, c), bits)
        z_hat_sel = dequantize(codes.view(b, h, w, c), qp)  # decoder sees this
        z_tilde = baf_conv_predict(baf, split, sel, z_hat_sel)  # no eq. (6)
        return charbonnier(tnn.leaky_relu(z_tilde), y_target)

    return loss_fn


def baf_grads(baf: BaFConv, z: torch.Tensor, loss_fn):
    """-> (loss, name -> gradient of each trainable BaF weight); nothing
    else gets a gradient."""
    params = trainable(baf)
    loss = loss_fn(baf, z)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def baf_step(baf: BaFConv, opt: AdamWState, lr, z: torch.Tensor, loss_fn,
             cfg: AdamWConfig):
    """One BaF training step on the split tensor ``z`` -> (opt, loss)."""
    loss, grads = baf_grads(baf, z, loss_fn)
    return apply_adamw(trainable(baf), grads, opt, lr, cfg), loss


def train_baf(model: CNN, cnn_cfg: CNNConfig, data_cfg: ShapesDatasetConfig,
              sel_idx, *, bits: int = 8, hidden: int = 64, steps: int = 600,
              lr: float = 2e-3, seed: int = 42, log_every: int = 200,
              verbose: bool = True, device=None) -> BaFTrainResult:
    """Train a BaF predictor for the channels ``sel_idx`` of the frozen
    ``model`` (its z computed without gradient)."""
    dev = _device_of(model, device)
    c = len(sel_idx)
    baf = BaFConv(BaFConvConfig(c=c, q=cnn_cfg.split_q, hidden=hidden),
                  seed=seed, device=dev)
    baf.requires_grad_(True)
    opt = adamw_init(trainable(baf))
    sched = cosine_with_warmup(lr, max(steps // 20, 1), steps)
    loss_fn = make_baf_loss(model, sel_idx, bits, device=dev)
    it = shapes_batch_iterator(data_cfg, seed=seed + 7, device=dev)
    losses = []
    for s in range(steps):
        img, _ = next(it)
        z = model.edge(img)[1]                           # frozen network
        opt, loss = baf_step(baf, opt, sched(s), z, loss_fn, BAF_ADAMW)
        if s % log_every == 0 or s == steps - 1:
            losses.append((s, float(loss)))
            if verbose:
                print(f"  [baf C={c} n={bits}] step {s:4d} charbonnier "
                      f"{float(loss):.5f}")
    baf.requires_grad_(False)
    sel = sel_idx.cpu().numpy() if isinstance(sel_idx, torch.Tensor) \
        else np.asarray(sel_idx)
    return BaFTrainResult(baf_params=baf, sel_idx=sel, losses=losses)
