"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, and under this folder a configuration (``configs/<name>.json``),
a traffic mix (``traffic/<name>.json``), a cell's parts and limits
(``cells/<name>.json``) and one reader per metric
(``readers/<metric>.py``). A later cell, mix or metric is a new file here;
nothing that exists needs an edit."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    """A cell's configuration and traffic names, its limits and the
    readings they were set from."""
    return _json(HERE / "cells" / f"{name}.json")


def cell_names() -> list[str]:
    """Every cell with a file here; BENCHMARK.json runs some of them."""
    return sorted(p.stem for p in (HERE / "cells").glob("*.json"))


def peaks() -> dict:
    return _json(HERE / "peaks.json")


def reader(metric: str):
    """The ``read(ctx)`` function of ``readers/<metric>.py``."""
    path = HERE / "readers" / f"{metric}.py"
    mod_name = "portbench_reader_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(cell_name: str, trace: bool) -> list[dict]:
    """The end-to-end metrics (``trace`` False) or the per-layer metrics
    (``trace`` True) that ``cell_name`` reports."""
    group = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
