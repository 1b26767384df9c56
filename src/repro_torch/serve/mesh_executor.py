"""MeshExecutor: the sharded cloud tier.

Counterpart of ``repro/serve/mesh_executor.py``. Every other executor
models the cloud as virtual queues in front of one device; this one puts
the real compute on a mesh of devices
(:class:`repro_torch.launch.mesh.LocalMesh`). The bound ``run_fn`` (the
gateway's ``_run_batch_mesh``) still does the batched host decode, but the
restore and the cloud forward run with batch-axis data parallelism: a
padded micro-batch of N rows is split into ``N / mesh.shape['data']``
contiguous rows per device, each device runs the same restore -> forward
on its shard (through the consolidate kernel when the plan is fused), and
the logits come back to the host in shard order. Every shard is queued
before any logits are copied back, so the cards of the mesh overlap.

The weights are replicated: on a device that holds the plan, the plan's
own modules serve and nothing is copied; on another, a replica plan (the
CNN, the BaF predictor, the channel selection and the kernels' channel
table, since ``consolidate_fused`` refuses a table on another device) is
built once per (plan, device) and cached. The reference replicates through
``params_pspecs`` with no data-axis factor; on the serving mesh the model
axis is 1, so every rule there resolves to a full copy per device too.

Bit-identity contract: per-row restore + forward is independent of its
batch-mates, so sharding the batch changes only the shape each device
computes at; a shard's rows equal the serial path's at that row count.

Virtual-clock planning: the per-batch service duration is the cost model
evaluated at the per-shard row count (``ceil(padded / n_data)``). With a
frozen :class:`~repro_torch.serve.executor.CalibratedCostModel` (fit on the
serial tier's measured samples, then ``freeze()``-d) the clock is a pure
function of the workload, so federated runs replay bit for bit. An unfrozen
calibrating model is refused at construction: it would record per-shard
sizes against whole-batch wall times and poison its own fit.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import pipeline
from repro_torch.launch.hlo_cost import analyze_program
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                     make_dev_mesh)
from repro_torch.pipeline.plan import DecodedBatch
from repro_torch.serve.executor import (CalibratedCostModel, CloudExecutor,
                                        CostModel, _Queue)


@dataclass(frozen=True)
class _ShardCost:
    """One batch as a single mesh device sees it — what the cost model is
    evaluated at (``padded_size`` = rows per shard, not rows per batch)."""
    padded_size: int
    key: Any = None


class MeshExecutor(CloudExecutor):
    """Cloud tier serving batched restore+forward from a device mesh.

    Parameters
    ----------
    mesh : LocalMesh with a batch-parallel axis (default:
        ``launch.mesh.make_dev_mesh(prefer="data")`` — every local card on
        the data axis, the serving shape; raises without a card)
    cost : CostModel for virtual service times, evaluated per shard. Pass a
        **frozen** :class:`CalibratedCostModel` for bit-identical replay;
        an unfrozen one is rejected.
    data_axis : mesh axis name the batch is sharded over
    overhead_s : fixed per-batch virtual overhead added on top of the
        per-shard cost (dispatch / collective headroom); 0 by default
    """

    def __init__(self, mesh=None, *, cost: CostModel | None = None,
                 data_axis: str = "data", overhead_s: float = 0.0):
        if isinstance(cost, CalibratedCostModel) and not cost.frozen:
            raise ValueError(
                "MeshExecutor needs a frozen CalibratedCostModel: calibrate "
                "on the serial tier, freeze(), then hand it over — a "
                "calibrating model would record per-shard sizes against "
                "whole-batch wall times and poison its own fit")
        super().__init__(queues=[_Queue(rate=1.0)], cost=cost)
        self.mesh = mesh if mesh is not None else make_dev_mesh(prefer="data")
        if data_axis not in self.mesh.shape:
            raise ValueError(f"mesh has no {data_axis!r} axis: "
                             f"{dict(self.mesh.shape)}")
        self.data_axis = data_axis
        self.n_data = int(self.mesh.shape[data_axis])
        self.overhead_s = float(overhead_s)
        # (id(plan), codes shape) -> (plan, [(rows, shard plan)]). The plan
        # ref is kept so id() stays valid for the cache's lifetime.
        self._fns: dict = {}
        self._replicas: dict = {}    # (id(plan), device) -> (plan, replica)

    # -- virtual clock -------------------------------------------------------
    def shard_rows(self, padded_size: int) -> int:
        """Rows each device computes for a batch of ``padded_size``."""
        return -(-int(padded_size) // self.n_data)

    def _plan_duration(self, batch, wall_s: float) -> float:
        view = _ShardCost(padded_size=self.shard_rows(batch.padded_size),
                          key=getattr(batch, "key", None))
        return self.overhead_s + self.cost.duration_s(view, wall_s)

    # -- sharded compute -----------------------------------------------------
    def _shard_plan(self, plan, device: torch.device):
        """The plan that runs on ``device``: ``plan`` itself where it lives,
        else its replica there (built once)."""
        if device == plan.device:
            return plan
        key = (id(plan), device)
        hit = self._replicas.get(key)
        if hit is None:
            spec = pipeline.ModelSpec(
                sel_idx=plan.spec.sel_idx,
                params=copy.deepcopy(plan.spec.params).to(device),
                baf_params=copy.deepcopy(plan.spec.baf_params).to(device))
            hit = (plan, pipeline.compile(
                plan.op, spec, fused=plan.fused,
                consolidation=plan.consolidation, device=device))
            self._replicas[key] = hit
        return hit[1]

    def _sharded_fn(self, plan, shape: tuple) -> list:
        """[(rows of the shard, the plan that runs it)] for a padded codes
        shape, one entry per index of the data axis."""
        key = (id(plan), tuple(shape))
        hit = self._fns.get(key)
        if hit is not None:
            return hit[1]
        rows = int(shape[0]) // self.n_data
        shards = [(slice(i * rows, (i + 1) * rows), self._shard_plan(plan, d))
                  for i, d in enumerate(self.mesh.devices_along(
                      self.data_axis))]
        self._fns[key] = (plan, shards)
        return shards

    def run_sharded(self, plan, decoded, target: int) -> np.ndarray:
        """Restore + cloud forward ``decoded`` across the mesh.

        Rows are padded (repeat-last, the serial path's bucket padding) to
        a multiple of the data-axis size so every device gets an equal
        shard; returns host logits for the first ``target`` rows.
        """
        if plan.spec.params is None or plan.spec.baf_params is None:
            raise ValueError("plan was compiled without model weights; "
                             "MeshExecutor cannot restore")
        dec = decoded.pad_to(self.shard_rows(target) * self.n_data)
        outs = []
        for rows, p in self._sharded_fn(plan, dec.codes.shape):
            shard = DecodedBatch(codes=dec.codes[rows], mins=dec.mins[rows],
                                 maxs=dec.maxs[rows])
            outs.append(p.spec.params.cloud(p.restore(shard)))
        # every shard is queued on its device before the first copy back
        return np.concatenate([o.cpu().numpy() for o in outs])[:target]


def restore_cloud_cost(plan, sample_shape: tuple) -> dict:
    """``analyze_program`` of a plan's restore + cloud forward, run once on
    zero codes of ``sample_shape`` (N, H, W, C) on the plan's device."""
    n, c = int(sample_shape[0]), int(sample_shape[-1])
    dev = plan.device
    codes = torch.zeros(tuple(sample_shape), device=dev,
                        dtype=torch.uint8 if plan.op.bits <= 8
                        else torch.uint16)
    mins = torch.zeros((n, 1, 1, c), dtype=torch.float16, device=dev)
    maxs = torch.ones((n, 1, 1, c), dtype=torch.float16, device=dev)
    return analyze_program(lambda: plan.spec.params.cloud(
        plan.restore_device(codes, mins, maxs)))


def seed_cost_from_program(plan, sample_shape: tuple, *,
                           flops_per_s: float | None = None,
                           bytes_per_s: float = HBM_BW
                           ) -> CalibratedCostModel:
    """Roofline-seeded :class:`CalibratedCostModel` for a plan's cloud body.

    Counts the restore + forward for one ``(N, H, W, C)`` codes shape with
    :func:`restore_cloud_cost` and seeds ``per_item_s`` with the roofline
    time ``max(flops/flops_per_s, bytes/bytes_per_s) / N``. ``flops_per_s``
    ``None`` takes the peak of the CNN's dtype: float32 (the BaF path runs
    with TF32 off) 67 TFLOP/s, bf16 989. Measured calibration samples
    override the seed at ``fit()``; the seed carries fits that would
    otherwise be degenerate (a single batch size in the samples).
    """
    if flops_per_s is None:
        dtype = next(plan.spec.params.parameters()).dtype
        flops_per_s = PEAK_FLOPS_F32 if dtype == torch.float32 \
            else PEAK_FLOPS_BF16
    est = restore_cloud_cost(plan, sample_shape)
    roof_s = max(est["flops"] / flops_per_s, est["bytes"] / bytes_per_s)
    return CalibratedCostModel(seed_per_item_s=roof_s / int(sample_shape[0]))
