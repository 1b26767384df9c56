"""Parameter, optimizer-state, batch and cache specs on a DeviceMesh.

Counterpart of ``repro/distributed/sharding.py``: the same 2D "megatron +
ZeRO-3" rule table (the tensor dim of every large matrix over ``model``,
the other over ``data``), with the same divisibility guard (a dim is
sharded only when the mesh axis divides it and it is longer than 1).

A spec is a tuple with one entry per dim: a mesh-axis name, a tuple of
them, or ``None``. ``to_placements`` turns it into the ``Shard`` /
``Replicate`` placements of a ``DTensor``, one per mesh dim: the
counterpart of ``params_shardings``' ``NamedSharding``.

The port's layout is per layer: a parameter is named ``layers.3.attn.wq``
(a dense layer's ``weight``/``bias`` stand for the reference's ``w``/``b``)
and a KV cache is (B, S, K, hd) per layer, where the reference stacks the
layers on a leading axis (L, ...). The rules align with a leaf's last
dims, so a parameter's spec is the reference's without the stacked dim,
and ``cache_pspecs``' dim indices are the reference's less one.

A mesh is a ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``) or a
mapping from axis name to size.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.optim.adamw import AdamWState

# (path names, spec template), first match wins. 'M' = the model axis,
# 'D' = the data (fsdp) axis; a template aligns with the leaf's last dims.
_RULES = [
    # embeddings / heads
    (("embed",),       ("M", "D")),
    (("dec_embed",),   ("M", "D")),
    (("dec_pos",),     (None, "D")),
    (("lm_head",),     ("D", "M")),
    # attention
    (("attn", "wq"),   ("D", "M")),
    (("attn", "wk"),   ("D", "M")),
    (("attn", "wv"),   ("D", "M")),
    (("attn", "wo"),   ("M", "D")),
    (("xattn", "wq"),  ("D", "M")),
    (("xattn", "wk"),  ("D", "M")),
    (("xattn", "wv"),  ("D", "M")),
    (("xattn", "wo"),  ("M", "D")),
    (("attn", "bq"),   ("M",)),
    (("attn", "bk"),   ("M",)),
    (("attn", "bv"),   ("M",)),
    (("xattn", "bq"),  ("M",)),
    (("xattn", "bk"),  ("M",)),
    (("xattn", "bv"),  ("M",)),
    # MoE (leading expert dim -> model axis = expert parallelism)
    (("moe", "router"), ("D", None)),
    (("moe", "wup"),    ("M", "D", None)),
    (("moe", "wgate"),  ("M", "D", None)),
    (("moe", "wdown"),  ("M", None, "D")),
    # dense FFN (also matches arctic's moe.dense residual)
    (("wgate",),       ("D", "M")),
    (("wup",),         ("D", "M")),
    (("wdown",),       ("M", "D")),
    # rwkv6
    (("mix_w1",),      ("D", None)),
    (("mix_w2",),      (None, None, "D")),
    (("wd_a",),        ("D", None)),
    (("wd_b",),        (None, "D")),
    (("cm_wk",),       ("D", "M")),
    (("cm_wv",),       ("M", "D")),
    (("cm_wr",),       ("D", "M")),
    (("wr",),          ("D", "M")),
    (("wg",),          ("D", "M")),
    (("wo",),          ("M", "D")),
    (("wk",),          ("D", "M")),
    (("wv",),          ("D", "M")),
    # mamba2
    (("in_proj",),     ("D", "M")),
    (("out_proj",),    ("M", "D")),
    (("conv_w",),      (None, "M")),
    (("conv_b",),      ("M",)),
    (("gate_norm",),   ("M",)),
    # BaF stream predictor (pod-boundary compression)
    (("l1", "w"),      ("D", "M")),
    (("l2", "w"),      ("M", "D")),
    (("l3", "w"),      ("D", "M")),
    (("l4", "w"),      ("M", "D")),
]

_DENSE_NAMES = {"weight": "w", "bias": "b"}
KV_NAMES = ("k", "v", "cross_k", "cross_v", "shared_k", "shared_v")


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, name) -> int:
    if name is None:
        return 1
    n = 1
    for a in (name if isinstance(name, tuple) else (name,)):
        n *= sizes[a]
    return n


def path_names(name: str) -> tuple:
    """``layers.3.attn.wq`` -> ('layers', '3', 'attn', 'wq'); a dense
    layer's ``weight``/``bias`` as the reference's ``w``/``b``."""
    return tuple(_DENSE_NAMES.get(p, p) for p in name.split("."))


def param_pspec(name: str, leaf, mesh, *, model_axis="model",
                data_axis: Optional[str] = "data") -> tuple:
    """The spec of parameter ``name`` (a tensor or a shape)."""
    sizes = axis_sizes(mesh)
    names = path_names(name)
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    ndim = len(shape)
    spec = [None] * ndim
    for keys, tmpl in _RULES:
        if all(k in names for k in keys):
            tmpl = tmpl[-ndim:] if len(tmpl) > ndim else tmpl
            for i, t in enumerate(tmpl):
                dim = ndim - len(tmpl) + i
                ax = None if t is None else (
                    model_axis if t == "M" else data_axis)
                if ax is not None and shape[dim] > 1 and \
                        shape[dim] % _axis_size(sizes, ax) == 0:
                    spec[dim] = ax
            break
    return tuple(spec)     # norms, scalars, small tables: replicated


def params_pspecs(params: dict, mesh, *, data_axis="data") -> dict:
    """{name: spec} for the trainer's ``{name: tensor}`` weights."""
    return {k: param_pspec(k, v, mesh, data_axis=data_axis)
            for k, v in params.items()}


def opt_state_pspecs(opt_state: AdamWState, params_specs: dict) -> AdamWState:
    """AdamW state: the count replicated, the moments as the params."""
    return AdamWState(count=(), mu=params_specs, nu=params_specs)


def batch_pspec(global_batch: int, mesh, *, multi_pod: bool):
    """The batch over (pod, data) where each divides it; None when
    neither does (a batch of 1 stays replicated)."""
    sizes = axis_sizes(mesh)
    usable, prod = [], 1
    for a in (("pod", "data") if multi_pod else ("data",)):
        if global_batch % (prod * sizes[a]) == 0:
            usable.append(a)
            prod *= sizes[a]
    if not usable:
        return None
    return tuple(usable) if len(usable) > 1 else usable[0]


def _map_tensors(fn, tree, path=()):
    """``tree`` with every tensor leaf t replaced by fn(path names, t) and
    every other leaf (lengths, positions, None) by ()."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return ()


def cache_pspecs(cache, mesh, batch_axes, *, model_axis="model",
                 seq_fallback: bool = True):
    """Specs of a decode cache, congruent with it. KV caches (B, S, K, hd):
    the batch over ``batch_axes``, the kv heads over ``model`` when it
    divides them, else the sequence (flash-decode) if ``seq_fallback``.
    SSM states (B, H, dk, dv): the batch, then the heads or the value dim;
    conv carries (B, W, C): the channels."""
    sizes = axis_sizes(mesh)
    msize = sizes[model_axis]
    bsize = _axis_size(sizes, batch_axes)

    def spec(names, leaf):
        nd = leaf.ndim
        if "length" in names or "pos" in names or nd == 0:
            return ()
        s = [None] * nd
        if batch_axes is not None and leaf.shape[0] % bsize == 0:
            s[0] = batch_axes
        if any(n in KV_NAMES for n in names) and nd == 4:
            if leaf.shape[2] % msize == 0:
                s[2] = model_axis
            elif seq_fallback and leaf.shape[1] % msize == 0:
                s[1] = model_axis
        elif "wkv" in names or "ssm" in names:
            if nd > 1 and leaf.shape[1] % msize == 0:
                s[1] = model_axis
            elif leaf.shape[-1] % msize == 0:
                s[-1] = model_axis
        elif "conv" in names and nd == 3:
            if leaf.shape[-1] % msize == 0:
                s[-1] = model_axis
        return tuple(s)

    return _map_tensors(spec, cache)


def to_placements(spec, mesh) -> tuple:
    """A spec -> one placement per mesh dim: ``Shard(d)`` where tensor dim
    d names that mesh axis (alone or in a tuple), else ``Replicate()``. An
    axis of size 1 shards nothing and gives ``Replicate()``, as a
    ``PartitionSpec`` over it is a no-op (DTensor would refuse to view a
    dim "sharded" one way)."""
    out = []
    shape = getattr(mesh, "shape", None) or (2,) * len(mesh.mesh_dim_names)
    for axis, size in zip(mesh.mesh_dim_names, shape):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {axis!r} shards dims {dims} of "
                             f"spec {spec}")
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)
