"""Smoke-size cells for the CPU tests: each cell at the size its family's
``smoke(cfg, traffic)`` gives, so that a whole run (set-up, window,
reference) takes about a second on the CPU, with the cell's own limits."""
from __future__ import annotations

from portbench import bench, spec


def smoke_cell(name: str) -> bench.Cell:
    """The cell ``name`` at smoke size, with its own limits."""
    c = spec.cell(name)
    cfg = spec.config(c["config"])
    cfg, traffic = spec.family_of(cfg).smoke(cfg, spec.traffic(c["traffic"]))
    return bench.Cell(name, cfg=cfg, traffic=traffic, limits=c["limits"])
