"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, and under this folder a configuration (``configs/<name>.json``),
the family that runs it (``families/<family>.py``, named by the
configuration's ``family`` key), a traffic mix (``traffic/<name>.json``),
a cell's parts and limits (``cells/<name>.json``) and one reader per
metric (``readers/<metric>.py``). A later family, configuration, cell,
mix or metric is a new file here; nothing that exists needs an edit."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the folders searched for parts, in order; a test puts one of its own first
DIRS = [HERE]
BENCHMARK = ROOT / "BENCHMARK.json"

_FAMILIES: dict[Path, object] = {}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _find(sub: str, name: str, suffix: str) -> Path:
    """The first ``<dir>/<sub>/<name><suffix>`` of :data:`DIRS`."""
    for d in DIRS:
        path = d / sub / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under "
                            f"{', '.join(str(d) for d in DIRS)}")


def _load(path: Path, mod_name: str):
    """The module at ``path``, registered as ``mod_name`` before it runs
    (a dataclass resolves its module by name)."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _json(BENCHMARK)


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """A configuration; it has to name a family that has a module."""
    path = _find("configs", name, ".json")
    cfg = _json(path)
    family_of(cfg, str(path))
    return cfg


def traffic(name: str) -> dict:
    return _json(_find("traffic", name, ".json"))


def cell(name: str) -> dict:
    """A cell's configuration and traffic names, its limits and the
    readings they were set from."""
    return _json(_find("cells", name, ".json"))


def cell_names() -> list[str]:
    """Every cell with a file here; BENCHMARK.json runs some of them."""
    return sorted({p.stem for d in DIRS for p in (d / "cells").glob("*.json")})


def peaks() -> dict:
    return _json(_find("", "peaks", ".json"))


def family(name: str):
    """The module ``families/<name>.py``, loaded once by its path."""
    path = _find("families", name, ".py")
    if path not in _FAMILIES:
        _FAMILIES[path] = _load(path, f"portbench_family_{len(_FAMILIES)}_"
                                + re.sub(r"\W", "_", name))
    return _FAMILIES[path]


def family_of(cfg: dict, where: str | None = None):
    """The family module that runs the configuration ``cfg`` (read from
    ``where``); there is no default family."""
    where = where or f"configuration {cfg.get('name')!r}"
    if "family" not in cfg:
        raise ValueError(f"{where}: no 'family' key; a configuration names "
                         f"the family that runs it (families/<family>.py)")
    try:
        return family(cfg["family"])
    except FileNotFoundError:
        raise ValueError(f"{where}: unknown family {cfg['family']!r}, no "
                         f"families/{cfg['family']}.py") from None


def reader(metric: str):
    """The ``read(ctx)`` function of ``readers/<metric>.py``."""
    return _load(_find("readers", metric, ".py"),
                 "portbench_reader_" + re.sub(r"\W", "_", metric)).read


def metrics_for(cell_name: str, trace: bool) -> list[dict]:
    """The end-to-end metrics (``trace`` False) or the per-layer metrics
    (``trace`` True) that ``cell_name`` reports."""
    group = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
