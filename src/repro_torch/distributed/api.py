"""Logical-axis sharding shim and the flash-decode context.

Counterpart of ``repro/distributed/api.py``. Models name the dims of an
activation by *logical* axes ("batch", "seq", "act_hidden", "heads",
...); an :class:`AxisRules` context binds those to the axes of a
``torch.distributed.device_mesh.DeviceMesh`` named ``("pod", "data",
"model")``. A spec is a tuple with, for each dim, a mesh-axis name, a
tuple of them, or ``None``: the counterpart of a ``PartitionSpec``.

``shard_hidden`` is a no-op outside a context. Inside one it
redistributes a ``DTensor`` to the placements the rules give
(``sharding.to_placements``) and returns a plain tensor unchanged. The
models call it where the reference does; their tensors are DTensors only
in a cell (``launch.specs.build_cell``), whose weights and batch are
placed on a ``DeviceMesh``.

Helpers carry what XLA does there without being asked:

  ``weight``     a weight sharded over a batch axis (FSDP, "data" or
                 "pod") is all-gathered on those axes before its use, as
                 the reference's partitioner gathers it; contracted as it
                 is against a batch-sharded input it would give a
                 ``Partial(sum)`` over "data".
  ``heads_view`` DTensor refuses to view a dim sharded into pieces that
                 are not whole heads (qwen2-7b's 28 heads over 16 ranks);
                 such a dim is replicated first, then ``shard_hidden``
                 shards the heads, unevenly where they do not divide.
  ``on_shards``  runs a function of plain tensors on each rank's local
                 shards and wraps the results, with their global shapes
                 given (``local_map`` takes the global shape as the local
                 one times the mesh size, wrong for an uneven shard);
                 ``heads_on_shards`` so runs attention math.

And three where DTensor itself falls short: ``lookup`` (an embedding read
from the table gathered whole), ``write_slot`` (a cache write into the
rank's own shard) and ``WholeProducts`` (a cell's products summed at once,
never left as partial sums).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import to_placements


MESH_AXES = ("pod", "data", "model")


def init_mesh(shape: tuple, *, backend: str, rank: int, world: int,
              init_file: str, device_type: str) -> DeviceMesh:
    """Join the default process group with ``backend`` (rendezvous through
    the file ``init_file``, no network) and lay the ``world`` ranks out
    as a DeviceMesh of ``shape`` over MESH_AXES. Nothing falls back: a
    backend that cannot start raises."""
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=MESH_AXES)


@dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (str, tuple of str, or None)."""
    rules: dict = field(default_factory=dict)

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.rules.get(a) if a else None for a in logical)


_state = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_ctx(rules: AxisRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def logical_axes(*names: Optional[str]) -> Optional[tuple]:
    r = current_rules()
    return r.spec(*names) if r is not None else None


def shard_hidden(x, *names: Optional[str]):
    """Redistribute a DTensor ``x`` to the placements of its logical axes
    ``names``; a plain tensor, or any tensor outside a context, as is. A
    dim shorter than its mesh axis stays replicated (a group dim of 1):
    DTensor would leave ranks with empty shards that no view accepts."""
    spec = logical_axes(*names)
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = tuple(
        Replicate() if isinstance(p, Shard) and x.shape[p.dim] < mesh.size(i)
        else p for i, p in enumerate(to_placements(spec, mesh)))
    return x.redistribute(mesh, placements)


def weight(w, dtype):
    """``w`` cast to ``dtype``; a DTensor first gathered over every mesh
    axis but "model" (FSDP: the batch axes shard it only at rest)."""
    if isinstance(w, DTensor):
        names = w.device_mesh.mesh_dim_names
        placements = tuple(Replicate() if n != "model" and p.is_shard()
                           else p for n, p in zip(names, w.placements))
        if placements != tuple(w.placements):
            w = w.redistribute(w.device_mesh, placements)
    return w.to(dtype)


_PRODUCTS = (torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.matmul,
             torch.Tensor.matmul, torch.mm, torch.bmm, torch.einsum)


def _whole(t):
    """DTensor ``t`` with every partial sum summed, to ``Replicate()``."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in t.placements))
    return t


class _WholeGrad(torch.autograd.Function):
    """The identity, whose backward sums a partial gradient at once."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _whole(grad)


class WholeProducts(TorchFunctionMode):
    """Inside a cell: a product of DTensors that comes out as a partial sum
    (its contraction dim sharded) is summed at once, to ``Replicate()``,
    and so is the gradient of each of its inputs. DTensor leaves such a
    ``Partial(sum)`` for the next op to resolve, and some of its versions
    then refuse that op (a bias, a residual or a second gradient sharded
    on the same mesh axis: "redistribute from S(0) to P(sum)", torch
    2.11)."""

    def __enter__(self):
        _state.summed = getattr(_state, "summed", 0) + 1
        return super().__enter__()

    def __exit__(self, *exc):
        _state.summed -= 1
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS or not any(isinstance(a, DTensor)
                                            for a in args):
            return func(*args, **kwargs)
        if torch.is_grad_enabled():
            args = tuple(_WholeGrad.apply(a) if isinstance(a, DTensor)
                         and a.requires_grad else a for a in args)
        return _whole(func(*args, **kwargs))


def products_summed() -> bool:
    """Is a ``WholeProducts`` mode active on this thread?"""
    return getattr(_state, "summed", 0) > 0


def with_summed_products(context_fn):
    """A checkpoint ``context_fn``: ``context_fn``'s forward context, and
    its recompute context with a ``WholeProducts`` mode around it (the
    backward's recompute does not run under the forward's modes)."""
    forward, recompute = context_fn()

    @contextlib.contextmanager
    def both():
        with recompute, WholeProducts():
            yield
    return forward, both()


def lookup(table, ids):
    """``table[ids]``: the rows of an embedding table, read through
    ``F.embedding`` (whose backward sums a token's rows in the same order
    in and out of a cell). A DTensor table is gathered whole first:
    DTensor's vocab-parallel rule (a masked partial sum) fails on
    batch-sharded ids, and its indexed read's backward (``index_put``) is
    refused by some versions (torch 2.11)."""
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh,
                                   (Replicate(),) * table.device_mesh.ndim)
    return F.embedding(ids, table)


def heads_view(x, shape: tuple, n_heads: int, dim: int = 2):
    """``x.reshape(shape)`` where ``dim`` of ``x`` or of ``shape`` holds
    ``n_heads`` heads; a DTensor whose ``dim`` is sharded over a mesh axis
    that does not divide ``n_heads``, or whose dims past ``dim`` (a head's
    own) are sharded, is replicated on that axis first."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        placements = tuple(
            Replicate() if isinstance(p, Shard) and (
                p.dim > dim or (p.dim == dim and n_heads % mesh.size(i)))
            else p for i, p in enumerate(x.placements))
        if placements != tuple(x.placements):
            x = x.redistribute(mesh, placements)
    return x.reshape(shape)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def on_shards(fn, inputs: tuple, in_placements: tuple,
              out_placements: tuple, out_shapes: tuple):
    """Redistribute each DTensor of ``inputs`` (None stays None) to its
    entry of ``in_placements``, run ``fn`` on the local shards, and wrap
    its outputs (a tensor or a tuple) as DTensors of ``out_placements``
    and the global ``out_shapes`` (each local output made contiguous, as
    the global stride says). Differentiable: ``to_local`` and
    ``from_local`` carry the gradients, an input's summed over the ranks
    where it is replicated and the work is split."""
    mesh = next(t for t in inputs if t is not None).device_mesh
    # an input replicated over a mesh axis that splits the work (an output
    # sharded or partial there) gets a different gradient on each rank:
    # their sum
    split = [any(not o[i].is_replicate() for o in out_placements)
             for i in range(mesh.ndim)]
    local = []
    for t, p in zip(inputs, in_placements):
        if t is None:
            local.append(None)
            continue
        grad = tuple(Partial("sum") if q.is_replicate() and split[i] else q
                     for i, q in enumerate(p))
        local.append(t.redistribute(mesh, p).to_local(grad_placements=grad))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        DTensor.from_local(o.contiguous(), mesh, p, run_check=False,
                           shape=torch.Size(s),
                           stride=_contiguous_stride(s))
        for o, p, s in zip(outs, out_placements, out_shapes))
    return wrapped[0] if single else wrapped


def local_head_range(mesh, placements, n_heads: int, dim: int = 2):
    """The [lo, hi) heads of this rank where ``placements`` shard ``dim``
    (at most one mesh axis), as ``torch.chunk`` splits them."""
    axes = [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]
    if not axes:
        return 0, n_heads
    if len(axes) > 1:
        raise ValueError(f"dim {dim} sharded over mesh axes {axes}: one "
                         f"axis at most")
    i = axes[0]
    size = -(-n_heads // mesh.size(i))
    lo = min(n_heads, mesh.get_local_rank(i) * size)
    return lo, min(n_heads, lo + size)


def write_slot(buf, slot: int, val) -> None:
    """``buf[:, slot] = val`` in place: buf (B, S, ...), val (B, ...). A
    DTensor ``buf`` is written in its local shard, by the rank whose shard
    holds ``slot`` where the sequence is sharded (an indexed write into a
    DTensor would land in a redistributed copy)."""
    if not isinstance(buf, DTensor):
        buf[:, slot] = val
        return
    mesh = buf.device_mesh
    vp = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1
               else Shard(p.dim - 1 if p.dim > 1 else 0)
               for p in buf.placements)
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    local = val.redistribute(mesh, vp).to_local()
    lo, hi = local_head_range(mesh, buf.placements, buf.shape[1], dim=1)
    if lo <= slot < hi:
        buf.to_local()[:, slot - lo] = local.to(buf.dtype)


def heads_on_shards(fn, q, k, v):
    """``fn(q, k, v)`` of attention inputs q (B, Sq, H, hd) and k, v (B,
    Sk, KH, hd) -> (B, Sq, H, hd_v), run on each rank's shards of DTensor
    inputs: the batch and the query heads keep their sharding, everything
    else is gathered; the kv heads are sharded with their query group
    where the mesh axis divides both head counts, else repeated to the
    query heads first (DTensor's ``repeat_interleave``, as the reference
    repeats them before its sharding constraint) and sharded as q's
    (``fn`` reads the group size from the shapes). Every input then has
    q's placements, so no rank's gradient is a partial sum. The output is
    sharded as q."""
    mesh = q.device_mesh
    h, kh = q.shape[2], k.shape[2]
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    n = 1
    for i, p in enumerate(qp):
        if p == Shard(2):
            n *= mesh.size(i)
    out_shape = (tuple(q.shape[:3]) + (v.shape[3],),)
    if kh != h and (h % n or kh % n):
        kp = tuple(Replicate() if p == Shard(2) else p for p in qp)
        k = k.redistribute(mesh, kp).repeat_interleave(h // kh, dim=2)
        v = v.redistribute(mesh, kp).repeat_interleave(h // kh, dim=2)
    return on_shards(fn, (q, k, v), (qp, qp, qp), (qp,), out_shape)


# Flash-decode context -------------------------------------------------------
# When set, attention_decode writes the token into a sequence-sharded KV
# cache and merges the shards' partial softmaxes
# (collectives.seq_sharded_decode_attention); the cache is never gathered.

@dataclass(frozen=True)
class FlashDecode:
    mesh: object                 # DeviceMesh with the reference's axis names
    axis: str = "model"
    batch_spec: object = "data"


def current_flash_decode() -> Optional[FlashDecode]:
    return getattr(_state, "flash_decode", None)


@contextlib.contextmanager
def flash_decode_ctx(mesh, *, axis: str = "model", batch_spec="data"):
    prev = getattr(_state, "flash_decode", None)
    _state.flash_decode = FlashDecode(mesh=mesh, axis=axis,
                                      batch_spec=batch_spec)
    try:
        yield
    finally:
        _state.flash_decode = prev


# Canonical rule sets -------------------------------------------------------

def train_rules(multi_pod: bool, *, seq_parallel: bool = True) -> AxisRules:
    """Training: batch -> (pod,) data; tensor dims -> model; fsdp -> data.
    ``seq_parallel=False`` leaves the residual stream replicated over the
    model axis."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(rules={
        "batch": batch,
        "seq": None,
        "act_hidden": "model" if seq_parallel else None,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "ffn_expert": None,      # expert F dim: expert dim already on model
        "vocab": "model",
        "fsdp": "data",
        "seq_model": "model",    # KV-cache / long-context seq sharding
    })


def serve_rules(multi_pod: bool, *, weight_mode: str = "2d",
                seq_parallel: bool = True) -> AxisRules:
    """Serving: as training; ``weight_mode`` '2d' keeps the fsdp sharding,
    'tp' leaves fsdp unbound (weights only tensor-sharded)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(rules={
        "batch": batch,
        "seq": None,
        "act_hidden": "model" if seq_parallel else None,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "ffn_expert": None,
        "vocab": "model",
        "fsdp": "data" if weight_mode == "2d" else None,
        "seq_model": "model",
    })
