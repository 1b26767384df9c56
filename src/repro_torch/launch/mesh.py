"""Meshes of the serving tier and the production shapes.

Counterpart of ``repro/launch/mesh.py``. The serving gateway is one
process, as the reference's single-controller mesh is, so a mesh here is a
small local object (:class:`LocalMesh`): an ordered axis-size mapping and
the devices laid out over it, row-major. ``distributed.sharding`` reads
its ``shape`` as it reads any mapping. Multi-process meshes are
``distributed.init_mesh``'s ``DeviceMesh``.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

# H100 SXM data sheet, dense rates, at the 700 W power limit (a card set
# below it runs slower under load)
PEAK_FLOPS_BF16 = 989e12        # bf16 on the tensor cores, per card
PEAK_FLOPS_F32 = 67e12          # float32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s per card and direction (NVLink 4)


@dataclass(frozen=True, eq=False)
class LocalMesh:
    """Axis sizes ``shape`` ({name: size}, in order) and ``devices``, the
    row-major layout of one device per mesh position (empty for a mesh
    that only names a shape)."""
    shape: dict
    devices: tuple = ()

    def __post_init__(self):
        n = 1
        for size in self.shape.values():
            n *= int(size)
        if self.devices and len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of shape {dict(self.shape)}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def devices_along(self, axis: str) -> list:
        """The device at each index of ``axis``, index 0 on every other
        axis (the replica that computes that index's shard)."""
        if not self.devices:
            raise ValueError(f"mesh of shape {dict(self.shape)} holds no "
                             f"devices")
        names = self.axis_names
        k = names.index(axis)
        stride = 1
        for name in names[k + 1:]:
            stride *= int(self.shape[name])
        return [self.devices[i * stride]
                for i in range(int(self.shape[axis]))]


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """The production shapes with no devices: one pod is (data=16,
    model=16); multi-pod adds a leading 'pod' axis of 2."""
    if multi_pod:
        return LocalMesh({"pod": 2, "data": 16, "model": 16})
    return LocalMesh({"data": 16, "model": 16})


def make_dev_mesh(n_devices: int | None = None, *, prefer: str = "model",
                  device=None) -> LocalMesh:
    """Small mesh over the local cards (tests, examples, serving).

    prefer="model" (default, train/dry-run): give the model axis the largest
    factor of n in (4, 2, 1). prefer="data" (serving): every entry on the
    batch axis, (data=n, model=1), the shape ``serve.mesh_executor`` wants.

    ``device=None`` takes every card ``torch.cuda.device_count()`` reports
    (n_devices of them, if given) and raises without one. A device given
    (``"cpu"``, ``"cuda:0"``) is listed ``n_devices`` times (default 1), so
    the CPU or one card can hold several shards.
    """
    if prefer not in ("data", "model"):
        raise ValueError(f"prefer must be 'data' or 'model', got {prefer!r}")
    if device is None:
        resolve_device(None)                  # raises without a card
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"{n} devices asked of {count} cards")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        devices = [resolve_device(device)] * n
    model = 1 if prefer == "data" else next(m for m in (4, 2, 1)
                                            if n % m == 0)
    return LocalMesh({"data": n // model, "model": model}, tuple(devices))
