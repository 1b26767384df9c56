"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line's fields.

A cell's configuration names its family (``families/<family>.py``); set-up
and the check call the family's functions (``portbench/README.md``, "a
model family"). Set-up (counted in ``setup_s`` from the start of
``run.py``): the family's seeded inputs, the port's objects, the clients'
work before the window, and one round of the cell's own traffic, which
builds the kernels and warms the libraries at exactly the window's shapes.
Then the window runs for ``seconds``; with ``trace`` it runs under
``torch.profiler`` with the program's ``obs.hooks`` timers installed.
After it the program's state is freed and the reference judges the
answers.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass

import torch

from portbench import loops, spec, trace

TRACE_TRIES = 3


@dataclass
class Context:
    """What a metric reader reads."""
    cfg: dict
    traffic: dict
    window: loops.Window
    trace: trace.Trace | None
    registry: object
    setup_s: float
    peaks: dict
    kernels: dict
    family: object               # the cell's family module


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """A cell's configuration, traffic and limits: by name from
    ``cells/<name>.json``, or given; and the family that runs it, which
    has to list the traffic's kind."""

    def __init__(self, name: str, *, cfg=None, traffic=None, limits=None):
        self.name = name
        if cfg is None or traffic is None or limits is None:
            c = spec.cell(name)
            cfg = cfg or spec.config(c["config"])
            traffic = traffic or spec.traffic(c["traffic"])
            limits = limits or c["limits"]
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.kind = traffic["kind"]
        self.family = spec.family_of(cfg)
        if self.kind not in self.family.KINDS:
            raise ValueError(f"{name}: family {cfg['family']!r} runs no "
                             f"traffic kind {self.kind!r} (its KINDS: "
                             f"{', '.join(self.family.KINDS)})")


class Setup:
    """The seeded inputs and the port's objects for one run."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        t0 = time.perf_counter()
        fam, cfg, traffic = cell.family, cell.cfg, cell.traffic
        self.cell, self.device = cell, device
        self.inputs = fam.make_inputs(cfg, traffic, seed, device)
        sync(device)
        t1 = time.perf_counter()
        self.prog = fam.build(cfg, traffic, self.inputs, device)
        t2 = time.perf_counter()
        fam.clients(cell.kind, self.prog, traffic, self.inputs, device)
        self.stages = {"inputs": t1 - t0, "program": t2 - t1,
                       "clients": time.perf_counter() - t2}

    def window(self, seconds: float, span) -> loops.Window:
        c = self.cell
        return c.family.window(c.kind, self.prog, c.traffic, self.inputs,
                               seconds, span, self.device)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.prog = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def traced_window(st: Setup, seconds: float):
    """The window under the profiler and the hooks -> (window, trace,
    registry). A session that recorded no device operation on a card is
    run again, up to TRACE_TRIES times."""
    from repro_torch.obs import hooks
    from repro_torch.obs.metrics import MetricsRegistry
    for _ in range(TRACE_TRIES):
        registry = MetricsRegistry()
        with hooks.active(registry):
            win, tr = trace.profiled(
                lambda: st.window(seconds, trace.spans(True)))
        if tr.ops or st.device.type != "cuda":
            return win, tr, registry
    raise RuntimeError(f"torch.profiler recorded no device operation in "
                       f"{TRACE_TRIES} sessions")


def run(cell: Cell, seed: int, seconds: float, traced: bool, *,
        device: torch.device, t_start: float) -> dict:
    """One run -> the result line (a dict; ``checks`` last)."""
    t0 = time.perf_counter()
    st = Setup(cell, seed, device)
    t1 = time.perf_counter()
    st.window(0.0, trace.spans(False))          # one round: warm-up
    sync(device)
    setup_s = time.perf_counter() - t_start
    print("set-up s: " + ", ".join(
        f"{k} {v!r}" for k, v in [("start", t0 - t_start), *st.stages.items(),
                                  ("warm-up", time.perf_counter() - t1)]),
        file=sys.stderr)
    if traced:
        win, tr, registry = traced_window(st, seconds)
    else:
        win, tr, registry = st.window(seconds, trace.spans(False)), None, None
    sync(device)
    print("window requests/s by quarter: " + ", ".join(
        f"{r:.1f}" for r in win.quarters()), file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    st.release()
    ctx = Context(cell.cfg, cell.traffic, win, tr, registry,
                  setup_s, spec.peaks(), trace.port_kernels(), cell.family)
    metrics = {}
    for m in spec.metrics_for(cell.name, traced):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    fam, args = cell.family, (cell.kind, cell.cfg, st.inputs, device)
    nums = fam.numbers(*args, win.frames, win.answers, fam.reference(*args))
    return result(cell, win, nums, metrics, device, peak, tr)


def verdict(cell: Cell, win: loops.Window, nums: dict) -> bool:
    """Every request answered, and every number within its limit."""
    return (win.completed > 0 and win.completed == win.attempted
            and set(nums) == set(cell.limits)
            and all(math.isfinite(v) and v <= cell.limits[k]
                    for k, v in nums.items()))


def result(cell, win, nums, metrics, device, peak, tr) -> dict:
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict(cell, win, nums), "attempted": win.attempted,
           "failed": win.attempted - win.completed, "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                     for k, v in nums.items()}
    return out

