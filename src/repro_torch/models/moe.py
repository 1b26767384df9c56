"""Mixture-of-Experts layer: top-k routing, fixed expert capacity,
gather-based dispatch and combine.

Counterpart of ``repro/models/moe.py``. Each group (one batch row in
prefill, the B tokens of a step in decode) routes on its own:

  routing   softmax over the experts in float32, the top k by a stable
            descending sort (ties go to the lower expert index, as
            ``jax.lax.top_k`` puts them; ``torch.topk`` promises no order
            for ties), renormalised;
  slots     GShard order: slot j of every token before slot j + 1; each
            expert keeps its first C (``capacity``) and the rest go to the
            pad column C;
  dispatch  an (E, C + 1) token table (sentinel T, the zero row) gathers
            the experts' inputs (E, C, D); the expert FFN is a batched
            matmul over the experts (the JAX package computes it outside
            any kernel);
  combine   each token fetches its k outputs (a dropped slot reads the
            zero pad row) weighted by its gates;
  aux       the switch load-balance loss, for the trainer.

The groups are routed together (one tensor op over all of them) where the
JAX package vmaps one group's function. Arctic's dense residual FFN runs
beside the experts on the same input. Weights in the JAX (in, out) layout.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.api import on_shards, shard_hidden
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.nn import frozen, normal, squared_relu


class MoE(nn.Module):
    """router (D, E), wup/wgate (E, D, F), wdown (E, F, D); ``dense`` when
    ``mcfg.dense_residual``."""

    def __init__(self, d_model: int, d_ff: int, mcfg: MoEConfig, act: str, *,
                 dtype=torch.float32, gen=None, device=None):
        super().__init__()
        e, f = mcfg.num_experts, mcfg.d_ff_expert
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.act = act
        self.router = frozen(normal((d_model, e), **kw))
        self.wup = frozen(normal((e, d_model, f), **kw))
        self.wdown = frozen(normal((e, f, d_model), **kw))
        if act == "swiglu":
            self.wgate = frozen(normal((e, d_model, f), **kw))
        self.dense = (FFN(d_model, d_ff, act, **kw)
                      if mcfg.dense_residual else None)


def capacity(tokens_per_group: int, mcfg: MoEConfig) -> int:
    """Slots per expert: k T / E times the capacity factor, rounded up to a
    multiple of 8, at least 8."""
    c = int(mcfg.top_k * tokens_per_group / mcfg.num_experts
            * mcfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """The routing of G groups of T tokens over E experts, top k."""
    probs: torch.Tensor        # (G, T, E) float32 router softmax
    top_p: torch.Tensor        # (G, T, k) float32 renormalised gates
    top_e: torch.Tensor        # (G, T, k) int64 experts, best first
    slot_pos: torch.Tensor     # (G, T, k) int64 slot in the expert, C = drop
    token_for: torch.Tensor    # (G, E, C + 1) int64 token of each slot, T = pad


def route(x: torch.Tensor, router: torch.Tensor, mcfg: MoEConfig,
          dtype) -> Routing:
    """x (G, T, D) -> the groups' routing tables."""
    g, t, _ = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    c = capacity(t, mcfg)
    logits = (x @ router.to(dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # GShard order: slot 0 of every token, then slot 1, ...; one running
    # count per expert over that order gives each slot its position
    order = top_e.transpose(1, 2).reshape(g, k * t)         # (G, kT)
    counts = torch.cumsum(F.one_hot(order, e).transpose(1, 2), dim=-1)
    pos = torch.gather(counts, 1, order[:, None, :])[:, 0] - 1
    pos = torch.where(pos < c, pos, c)                       # overflow: pad
    token_for = torch.full((g, e, c + 1), t, dtype=torch.int64,
                           device=x.device)
    rows = torch.arange(g, device=x.device)[:, None]
    tokens = torch.arange(t, device=x.device).repeat(k)[None, :]
    token_for[rows, order, pos] = tokens.expand(g, k * t)
    # dropped tokens may have written the pad column: restore it
    token_for[:, :, c] = t
    return Routing(probs, top_p, top_e, pos.reshape(g, k, t).transpose(1, 2),
                   token_for)


def _experts(p: MoE, xe: torch.Tensor, dtype) -> torch.Tensor:
    """xe (E, N, D) -> (E, N, D) through each expert's FFN."""
    up = torch.bmm(xe, p.wup.to(dtype))
    if p.act == "swiglu":
        h = F.silu(torch.bmm(xe, p.wgate.to(dtype))) * up
    elif p.act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        h = squared_relu(up)
    return torch.bmm(h, p.wdown.to(dtype))


def _local_params(p, names: list, leaves) -> SimpleNamespace:
    """``p``'s attributes with its parameters replaced by ``leaves``."""
    by = dict(zip(names, leaves))
    sub = {}
    for name in [n for n in names if "." in n]:
        mod, leaf = name.split(".", 1)
        sub.setdefault(mod, {})[leaf] = by.pop(name)
    ns = SimpleNamespace(act=p.act, **by)
    if getattr(p, "dense", None) is not None:
        ns.dense = SimpleNamespace(act=p.dense.act, **sub["dense"])
    elif hasattr(p, "dense"):
        ns.dense = None
    return ns


def _moe_on_shards(p: MoE, x, mcfg: MoEConfig, dtype, routes):
    """``moe_apply`` on each rank's rows of a DTensor ``x``: the groups
    (rows) stay sharded over the batch axes, everything else is gathered,
    the experts' weights whole. A row routes alone, so each rank's groups
    route as they would in one process -> (y, the balance loss of each
    group)."""
    mesh = x.device_mesh
    xp = tuple(q if q == Shard(0) else Replicate() for q in x.placements)
    whole = (Replicate(),) * mesh.ndim
    names = [n for n, _ in p.named_parameters()]
    leaves = [functools.reduce(getattr, n.split("."), p) for n in names]

    def local(xl, *ws):
        return _moe_groups(_local_params(p, names, ws), xl, mcfg, dtype,
                           routes)
    # the balance loss a group, sharded with the groups
    return on_shards(local, (x, *leaves), (xp,) + (whole,) * len(leaves),
                     (xp, xp), (x.shape, (x.shape[0],)))


def moe_apply(p: MoE, x: torch.Tensor, mcfg: MoEConfig, *, dtype=None,
              routes: list | None = None):
    """x (B, S, D): each batch row is a routing group -> (y (B, S, D), aux:
    the balance loss averaged over the groups). Arctic adds the dense
    residual FFN over the same input. ``routes``, when given, gets the
    groups' ``Routing``. A DTensor ``x`` runs each rank's rows on their
    own (``_moe_on_shards``)."""
    dtype = dtype or x.dtype
    if isinstance(x, DTensor):
        y, aux = _moe_on_shards(p, x, mcfg, dtype, routes)
        return shard_hidden(y, "batch", None, None), aux.mean()
    y, aux = _moe_groups(p, x, mcfg, dtype, routes)
    return y, aux.mean()


def _moe_groups(p: MoE, x, mcfg: MoEConfig, dtype, routes):
    """``moe_apply`` on plain tensors -> (y, the balance loss of each
    group (G,))."""
    g, t, d = x.shape
    e = mcfg.num_experts
    r = route(x, p.router, mcfg, dtype)
    c = r.token_for.shape[-1] - 1
    if routes is not None:
        routes.append(r)
    rows = torch.arange(g, device=x.device)
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
    xe = x_pad[rows[:, None, None], r.token_for[:, :, :c]]   # (G, E, C, D)
    ye = _experts(p, xe.transpose(0, 1).reshape(e, g * c, d), dtype)
    ye = ye.reshape(e, g, c, d).transpose(0, 1)               # (G, E, C, D)
    ye_pad = torch.cat([ye, ye.new_zeros((g, e, 1, d))], dim=2)
    fetched = ye_pad[rows[:, None, None], r.top_e, r.slot_pos]  # (G,T,k,D)
    y = (fetched * r.top_p[..., None].to(ye.dtype)).sum(dim=2)
    if p.dense is not None:
        y = y + ffn_apply(p.dense, x, dtype=dtype)
    frac_tokens = F.one_hot(r.top_e[..., 0], e).float().mean(dim=1)
    return y, e * (frac_tokens * r.probs.mean(dim=1)).sum(-1)
