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
models do not call it yet: they run on one device or as one process per
pod, whose tensors are plain.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

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
    ``names``; a plain tensor, or any tensor outside a context, as is."""
    spec = logical_axes(*names)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


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
