"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line's fields.

Set-up (counted in ``setup_s`` from the start of ``run.py``): the seeded
weights and frames on the device, the port's objects, the clients' blobs
(cloud cells), and one round of the cell's own traffic, which builds the
kernels and warms cuDNN at exactly the window's shapes. Then the window
runs for ``seconds``; with ``trace`` it runs under ``torch.profiler`` with
the program's ``obs.hooks`` timers installed. After it the program's
state is freed and the reference judges the answers.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass

import torch

from portbench import inputs, judge, loops, spec, system, trace

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


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """A cell's configuration, traffic and limits: by name from
    ``cells/<name>.json``, or given."""

    def __init__(self, name: str, *, cfg=None, traffic=None, limits=None):
        self.name = name
        if cfg is None or traffic is None or limits is None:
            c = spec.cell(name)
            cfg = cfg or spec.config(c["config"])
            traffic = traffic or spec.traffic(c["traffic"])
            limits = limits or c["limits"]
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.kind = traffic["kind"]


class Setup:
    """The seeded inputs and the port's objects for one run."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        t0 = time.perf_counter()
        cfg, traffic = cell.cfg, cell.traffic
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        self.cell, self.device = cell, device
        gen = inputs.generator(seed, device)
        self.weights = inputs.make_weights(cfg, gen, device)
        frames = inputs.make_frames(cfg, traffic["pool"], gen, device)
        self.frames_host = frames.cpu().numpy()
        self.sel = inputs.make_selection(cfg, seed)
        self.schedule = inputs.Schedule(seed, traffic["pool"],
                                        traffic.get("sample_share", 1.0))
        sync(device)
        t1 = time.perf_counter()
        self.prog = system.build(cfg, traffic, self.weights, self.sel, device)
        t2 = time.perf_counter()
        self.pool_blobs = None
        if cell.kind == "cloud_closed_loop":
            # the clients' work: every pool frame through the port's edge
            self.pool_blobs = [self.prog.plan.encode(self.prog.edge(
                frames[i:i + 1])) for i in range(frames.shape[0])]
        del frames
        self.stages = {"inputs": t1 - t0, "program": t2 - t1,
                       "clients": time.perf_counter() - t2}

    def window(self, seconds: float, span) -> loops.Window:
        t, p = self.cell.traffic, self.prog
        if self.cell.kind == "cloud_closed_loop":
            return loops.cloud_closed_loop(p, t, self.pool_blobs,
                                           self.schedule, seconds, span)
        if self.cell.kind == "edge_closed_loop":
            return loops.edge_closed_loop(p, t, self.frames_host,
                                          self.schedule, seconds, span,
                                          self.device)
        return loops.gateway_serve(p, t, self.frames_host, seconds, span)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.prog = None
        self.pool_blobs = None
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
                  setup_s, spec.peaks(), trace.port_kernels())
    metrics = {}
    for m in spec.metrics_for(cell.name, traced):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    want = judge.reference_for(cell.kind, cell.cfg, st.weights, st.sel,
                               st.frames_host, device)
    nums = judge.numbers(cell.kind, cell.cfg, st.weights, st.sel,
                         st.frames_host, device, win.frames, win.answers,
                         want)
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

