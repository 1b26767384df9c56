"""Multi-task serving: one encoded BaF stream, N downstream task heads.

Counterpart of ``repro.tasks`` on the port's gateway and plans.

The task layer on top of pipeline + serve (see docs/MULTITASK.md):

  * :mod:`repro_torch.tasks.heads` — the TaskHead registry (classify /
    detect / embed) with forwards over the restored tensor;
  * :mod:`repro_torch.tasks.distortion` — per-task output-divergence RD
    tables (one encode/decode/restore per operating point, head fan-out);
  * :mod:`repro_torch.tasks.allocation` — deterministic bit allocation
    across a tenant's declared task set (degrade-before-shed under
    pressure);
  * :mod:`repro_torch.tasks.gateway` — MultiTaskGateway: one decode + one
    restore per micro-batch fanned out to every subscribed head.
"""
from repro_torch.tasks.allocation import (AllocationDecision,
                                          BitAllocationController)
from repro_torch.tasks.distortion import (build_task_rd_tables,
                                          divergence_to_db,
                                          load_or_build_task_tables,
                                          task_divergences, task_set_key)
from repro_torch.tasks.gateway import MultiTaskGateway, MultiTaskResponse
from repro_torch.tasks.heads import (HeadConfig, TaskHead, available_heads,
                                     get_head, init_head_bank, register_head,
                                     run_heads)

__all__ = [
    "AllocationDecision", "BitAllocationController",
    "build_task_rd_tables", "divergence_to_db", "load_or_build_task_tables",
    "task_set_key", "task_divergences",
    "MultiTaskGateway", "MultiTaskResponse",
    "HeadConfig", "TaskHead", "available_heads", "get_head",
    "init_head_bank", "register_head", "run_heads",
]
