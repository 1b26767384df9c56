"""LM training step, single process: microbatch gradient accumulation, bf16
compute over float32 master weights, remat'd blocks, AdamW under a cosine
schedule.

Counterpart of ``repro/train/trainer.py``. The master weights are a dict
from the port's parameter names (``layers.3.attn.wq``) to float32 tensors
(``init_params``, or ``bridge.master_from_jax`` for the JAX package's).
A step casts them to ``cfg.dtype``, runs the loss of ``loss_for(cfg)`` on
a skeleton of the model (built on the ``meta`` device, so it holds no
weights) through ``torch.func.functional_call``, takes the gradients with
respect to that cast copy and casts them to float32, as the reference's
``grads_of`` does. The backward runs inside the ``functional_call``:
``torch.utils.checkpoint`` recomputes the blocks there and must find the
cast copy in the skeleton, which the call swaps out when it returns.

Microbatches: the float32 gradients of each are summed, then the loss and
the gradients are divided by their number. A batch DTensor-sharded on its
rows is split within each rank; where a rank's rows are fewer than the
microbatches (or do not split that many ways), the step runs gcd(rows a
rank, microbatches) of them (``_groups``). The update is the port's
``adamw_update`` with its global-norm clip, leaf by leaf and written into
the state's tensors, so a step takes 16 B a parameter beyond its
activations (master, two moments, the float32 gradients) where the
reference's launcher gets the same from ``donate_argnums=(0,)``: the step
consumes the state it is given. The weight-decay mask is the reference's
default (ndim >= 2) on the reference's layout, where the layers are
stacked: every leaf of a layer is decayed, norms and biases included.

Multi-pod training with ``grad_compress_bits`` and ``multi_pod=True``
runs one process per pod over the ``pod`` axis of a ``DeviceMesh``: each
rank takes its pod's contiguous share of the global batch (as ``P("pod")``
splits it), computes its gradients, adds its error-feedback residuals,
and exchanges every leaf with n-bit codes (``optim.grad_compress``); the
loss is averaged over the pods, the new residuals are kept for the next
step, and AdamW runs on the exchanged mean, the same on every pod.
Without ``multi_pod`` the field is ignored, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.api import axis_ctx, train_rules
from repro_torch.distributed.collectives import axis_group
from repro_torch.models.encdec import encdec_loss, init_encdec
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_scale, cosine_with_warmup,
                               global_norm)
from repro_torch.optim.grad_compress import _quantized_psum_one

# the parameter names of the layers the reference stacks on a leading axis
STACKED = ("layers.", "enc_layers.", "dec_layers.")


@dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()
    # cross-pod gradient compression (None = exact all-reduce)
    grad_compress_bits: Optional[int] = None
    error_feedback: bool = True
    # activation-checkpoint policy: 'full' | 'dots' | 'dots_no_batch'
    remat_policy: str = "full"


class TrainState(NamedTuple):
    params: dict               # name -> float32 master weight
    opt: AdamWState            # float32 moments, congruent with params
    step: torch.Tensor         # 0-dim int32, on the CPU
    ef: Optional[dict] = None  # error-feedback residuals (grad compression)


def _model(cfg: ArchConfig, **kw) -> nn.Module:
    return (init_encdec if cfg.family == "audio" else init_lm)(cfg, **kw)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """Float32 master weights drawn from ``seed`` on ``device`` (``None`` =
    the card): the values of the model the port draws for ``cfg``, before
    any cast to the compute dtype; ``requires_grad=True``."""
    model = _model(cfg.with_(dtype=torch.float32), seed=seed, device=device)
    return {name: p.detach().requires_grad_(True)
            for name, p in model.named_parameters()}


def init_train_state(params: dict, tcfg: TrainConfig) -> TrainState:
    ef = None
    if tcfg.grad_compress_bits is not None and tcfg.error_feedback:
        ef = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()}
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32), ef=ef)


def loss_for(cfg: ArchConfig):
    return encdec_loss if cfg.family == "audio" else lm_loss


def stacked_decay(name: str, leaf: torch.Tensor) -> bool:
    """The reference's default decay mask (ndim >= 2) on its stacked
    layout, where a layer's leaf has one more dim than here."""
    return leaf.ndim >= 2 or name.startswith(STACKED)


class _LossAndGrads(nn.Module):
    """The loss of ``model`` on a batch and its gradients with respect to
    ``leaves``, in one call, so that a remat recompute in the backward
    still sees the weights ``functional_call`` put in."""

    def __init__(self, model: nn.Module, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch: dict, leaves: list):
        loss = self.loss_fn(self.model, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), grads


def _chunk(v, n: int, i: int):
    """Rows i/n of ``v``; of a DTensor sharded on its batch, the i-th n-th
    of each rank's rows (the same rows in another grouping: the loss and
    gradient sums over the microbatches do not change, and no rows move
    between ranks). A rank's rows must split n ways."""
    if isinstance(v, DTensor) and Shard(0) in v.placements:
        rows = v.to_local().shape[0]
        if rows % n:
            raise ValueError(f"{rows} rows a rank do not split into {n} "
                             f"microbatches")
        loc = v.to_local().chunk(n)[i]
        shape = (v.shape[0] // n,) + tuple(v.shape[1:])
        return DTensor.from_local(loc, v.device_mesh, v.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=loc.stride())
    return v.chunk(n)[i]


def _groups(batch: dict, n: int) -> int:
    """How many microbatches the step runs for ``n`` asked: ``n``, or for a
    batch DTensor-sharded on its rows whose r rows a rank do not split n
    ways, gcd(r, n), of r / gcd(r, n) rows a rank each. Where n is a
    multiple of r (8 rows a rank in 16 microbatches: arctic-480b's and
    qwen2-72b's ``train_4k`` on two pods) that is a row a rank, as many
    as the reference's microbatches hold a device once XLA pads them,
    and every row real. The mean loss and gradients over equal
    microbatches are the means over all the rows either way, for MoE
    too: each row is its own routing group, with its own capacity and
    balance loss."""
    for v in batch.values():
        if isinstance(v, DTensor) and Shard(0) in v.placements:
            return math.gcd(v.to_local().shape[0], n)
    return n


def _microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) leaves -> ``_groups(batch, n)`` dicts of equal rows, in
    order."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    m = _groups(batch, n)
    return [{k: _chunk(v, m, i) for k, v in batch.items()} for i in range(m)]


def make_grads_fn(cfg: ArchConfig, tcfg: TrainConfig):
    """-> grads_of(params, batch) -> (mean loss, float32 gradients by name),
    accumulated over ``tcfg.num_microbatches``, the forward in
    ``cfg.dtype``."""
    base = loss_for(cfg)
    if cfg.family == "audio":
        loss_fn = base               # encdec has its own fixed remat
    else:
        def loss_fn(model, batch):
            return base(model, batch, remat_policy=tcfg.remat_policy)
    bound = _LossAndGrads(_model(cfg, device="meta"), loss_fn)
    n = tcfg.num_microbatches

    def grads_of(params: dict, batch: dict):
        names = list(params)
        cast = [params[k].detach().to(cfg.dtype).requires_grad_(True)
                for k in names]
        weights = {"model." + k: t for k, t in zip(names, cast)}
        loss, acc = None, None
        mbs = _microbatches(batch, n)
        for mb in mbs:
            l, gs = torch.func.functional_call(bound, weights, (mb, cast))
            gs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  if g is None else g.float() for g, t in zip(gs, cast)]
            loss = l if loss is None else loss + l
            acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
        div = torch.tensor(float(len(mbs)), device=loss.device)
        return loss / div, {k: g / div for k, g in zip(names, acc)}
    return grads_of


@torch.no_grad()
def _update(state: TrainState, grads: dict, lr, acfg: AdamWConfig):
    """AdamW on every leaf, written into the state's tensors -> (new opt
    state, metrics). The clip scale comes from the global norm of all the
    gradients first, as in ``adamw_update``."""
    metrics = {}
    scale = None
    if acfg.clip_norm is not None:
        metrics["grad_norm"] = global_norm(grads)
        scale = clip_scale(metrics["grad_norm"], acfg.clip_norm)
    if acfg.decay_mask is None:
        acfg = acfg._replace(decay_mask=stacked_decay)
    one = acfg._replace(clip_norm=None)
    opt = state.opt
    for k, p in state.params.items():
        g = grads.pop(k)
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        new_p, new_opt, _ = adamw_update(
            {k: g}, AdamWState(opt.count, {k: opt.mu[k]}, {k: opt.nu[k]}),
            {k: p}, lr, one)
        p.copy_(new_p[k])
        opt.mu[k].copy_(new_opt.mu[k])
        opt.nu[k].copy_(new_opt.nu[k])
    return AdamWState(opt.count + 1, opt.mu, opt.nu), metrics


def pod_share(batch: dict, npod: int, pod: int) -> dict:
    """Pod ``pod``'s contiguous 1/npod of every (B, ...) leaf's rows."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % npod:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {npod} pods")
        out[k] = v.chunk(npod)[pod]
    return out


@torch.no_grad()
def pod_exchange(grads: dict, ef: Optional[dict], bits: int, group,
                 npod: int) -> None:
    """In place, leaf by leaf: grads[k] (+ ef[k]) -> the pods' mean with
    n-bit codes on the wire; ef[k] <- this pod's residual."""
    for k in list(grads):
        g = grads[k] if ef is None else grads[k] + ef[k]
        grads[k], resid = _quantized_psum_one(g, bits, group, npod)
        if ef is not None:
            ef[k].copy_(resid)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, *, mesh=None,
                    multi_pod: bool = False):
    """-> train_step(state, batch) -> (new state, metrics: loss, grad_norm,
    lr). The step updates ``state``'s tensors in place and returns them in
    the new state. With ``grad_compress_bits`` and ``multi_pod``, ``mesh``
    is the DeviceMesh whose ``pod`` axis the exchange runs over, ``batch``
    the global batch, and each rank trains on its pod's share."""
    compressed = tcfg.grad_compress_bits is not None and multi_pod
    if compressed and mesh is None:
        raise ValueError("the compressed cross-pod exchange needs the mesh "
                         "whose 'pod' axis it runs over")
    grads_of = make_grads_fn(cfg, tcfg)
    sched = cosine_with_warmup(tcfg.peak_lr, tcfg.warmup_steps,
                               tcfg.total_steps)
    if compressed:
        group, npod, pod = axis_group(mesh, "pod")

    def train_step(state: TrainState, batch: dict):
        if compressed:
            with axis_ctx(train_rules(False)):
                loss, grads = grads_of(state.params,
                                       pod_share(batch, npod, pod))
            pod_exchange(grads, state.ef, tcfg.grad_compress_bits, group,
                         npod)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / torch.full((), float(npod), device=loss.device)
        else:
            loss, grads = grads_of(state.params, batch)
        lr = sched(state.step)
        opt, metrics = _update(state, grads, lr, tcfg.adamw)
        metrics.update(loss=loss, lr=lr)
        return TrainState(params=state.params, opt=opt, step=state.step + 1,
                          ef=state.ef), metrics
    return train_step
