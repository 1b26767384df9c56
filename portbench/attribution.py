"""Device operations put down to the program's stages, and the card's idle
gaps to the stage the host was in, from one ``torch.profiler`` session.

With a registry installed, the program (``repro_torch.obs.hooks``) opens a
host range named after each timed stage (``split.edge``,
``pipeline.restore``, ...); the benchmark opens its ``pb.*`` ranges around
each call into the program. :func:`collect` reads a session's events into
an :class:`Attributed` trace: the ``trace.Trace`` that ``trace.profiled``
builds, with its device operations chosen by activity type instead of by
name (a user annotation's mirror on the device's timeline is dropped
whatever its name), plus the program's ranges and, for each device
operation, the host time of the runtime call that launched it (the one
with its correlation id). The innermost program range open at that time
is the stage that launched the operation. The serving path launches from
one host thread, which this assumes.

Run a cell's window three ways in one process (plain, with the hooks
installed, and traced) and print where the card's time and its idle time
went, by stage:

    python portbench/attribution.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]
"""
from __future__ import annotations

import bisect
import json
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import trace  # noqa: E402

# the CUDA API's calls on the host (cudaLaunchKernel, cudaLaunchKernelExC,
# cudaMemcpyAsync, cuLaunchKernel, ...): a device operation carries the
# correlation id of the call that launched it
LAUNCH = re.compile(r"cu(da)?[A-Z]\w*$")
# the readers of the per-stage readings, and of the readings they sum to
READINGS = ("restore_device_ms", "cloud_device_ms", "edge_device_ms",
            "edge_host_ms", "codec_host_ms", "model_device_ms",
            "device_idle_share")


def _innermost_map(ranges):
    """Properly nested ``(name, start, end)`` ranges -> (times, names): the
    innermost range open from ``times[i]`` on is ``names[i]`` (None where
    none is)."""
    times, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][2] <= t:
            end = stack.pop()[2]
            times.append(end)
            names.append(stack[-1][0] if stack else None)

    for name, a, b in sorted(ranges, key=lambda r: (r[1], -r[2])):
        close_until(a)
        stack.append((name, a, b))
        times.append(a)
        names.append(name)
    close_until(float("inf"))
    return times, names


def _lookup(table, t):
    times, names = table
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


@dataclass
class Attributed(trace.Trace):
    program: list = field(default_factory=list)   # (stage, start_ns, end_ns)
    launch: list = field(default_factory=list)    # launch host ns per op
    _table: tuple | None = field(default=None, repr=False)

    def stage_at(self, t) -> str | None:
        """The innermost program range open at host time ``t``."""
        if self._table is None:
            self._table = _innermost_map(self.program)
        return _lookup(self._table, t)

    def launched_by(self) -> list:
        """The stage that launched each of ``ops`` (None: no launch found,
        or launched outside every program range)."""
        return [None if t is None else self.stage_at(t) for t in self.launch]

    def device_ns_by_stage(self) -> dict:
        """Device ns of the operations each stage launched itself (its
        innermost ranges), None for the unattributed."""
        out: dict = {}
        for (_, a, b), stage in zip(self.ops, self.launched_by()):
            out[stage] = out.get(stage, 0) + (b - a)
        return out

    def device_ns_within(self, stage: str) -> int:
        """Device ns of every operation launched inside a ``stage`` range,
        its child stages' included."""
        starts, ends = [], []
        for name, a, b in sorted(r for r in self.program if r[0] == stage):
            if ends and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
        ns = 0
        for (_, a, b), t in zip(self.ops, self.launch):
            if t is not None:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= ends[i]:
                    ns += b - a
        return ns

    def unattributed_share(self) -> float:
        """Share of the summed device-operation time that no program range
        launched."""
        total = sum(b - a for _, a, b in self.ops)
        return self.device_ns_by_stage().get(None, 0) / total if total else 0.0

    def idle_gaps(self, n: int = 10) -> list[list]:
        """``trace.Trace.idle_gaps`` with each benchmark span's gaps split
        by the program range holding the gap's middle:
        ``<benchmark span>/<stage>``, or the benchmark span alone where no
        program range holds it. Each benchmark span's total is unchanged."""
        busy = self.busy()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        spans = sorted((s for s in self.spans if s[0] != trace.WINDOW),
                       key=lambda s: s[1])
        starts = [s[1] for s in spans]
        total: dict[str, int] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "host idle"
            # as trace.Trace.idle_gaps names the benchmark span
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - 4, -1), -1):
                if spans[i][2] > mid:
                    name = spans[i][0]
                    break
            stage = self.stage_at(mid)
            if stage is not None:
                name = f"{name}/{stage}"
            total[name] = total.get(name, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def device_ms(ctx, stage: str) -> float | None:
    """Device ms a request of every operation launched inside ``stage``
    (``ctx``: ``bench.Context``); None unless ``ctx.trace`` is an
    :class:`Attributed` trace (of this module, or of it run as a script)
    that holds the stage."""
    program = getattr(ctx.trace, "program", ())
    if not any(r[0] == stage for r in program):
        return None
    return ctx.trace.device_ns_within(stage) / 1e6 / ctx.window.completed


def stage_names(registry) -> set[str]:
    """Every stage the program timed into ``registry``."""
    return {labels["stage"] for name, labels, _ in registry.collect()
            if name == "stage_seconds"}


def collect(events, stages) -> Attributed:
    """Kineto events (``prof.profiler.kineto_results.events()``) and the
    program's stage names -> :class:`Attributed`."""
    from torch.autograd import DeviceType
    tr = Attributed()
    launches: dict[int, int] = {}
    corr = []
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a user annotation's range is mirrored on the device's timeline
            if not e.is_user_annotation():
                tr.ops.append((name, a, b))
                corr.append(e.correlation_id())
        elif name.startswith(trace.PREFIX):
            tr.spans.append((name[len(trace.PREFIX):]
                             if name != trace.WINDOW else name, a, b))
            if name == trace.WINDOW:
                tr.window = (a, b)
        elif name in stages:
            tr.program.append((name, a, b))
        elif LAUNCH.match(name):
            launches[e.correlation_id()] = a
    tr.launch = [launches.get(c) for c in corr]
    return tr


def profiled(fn, registry):
    """Run ``fn()`` under ``torch.profiler`` inside a ``pb.window`` span with
    ``registry`` installed -> (its result, :class:`Attributed`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import hooks

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with hooks.active(registry):
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, collect(prof.profiler.kineto_results.events(),
                        stage_names(registry))


def _per_request(ns: int, completed: int) -> float:
    return ns / 1e6 / completed


def summary(ctx) -> dict:
    """What a traced window's :class:`Attributed` trace says, a request at
    a time (``ctx``: ``bench.Context``)."""
    from portbench import spec
    tr, done = ctx.trace, ctx.window.completed
    ops_ns = sum(b - a for _, a, b in tr.ops)
    within = {s: tr.device_ns_within(s) for s in sorted(stage_names(
        ctx.registry))}
    host = {}
    for name, labels, m in ctx.registry.collect():
        if name == "stage_seconds":
            host[labels["stage"]] = host.get(labels["stage"], 0.0) + m.total
    by_stage = tr.device_ns_by_stage()
    named = sum(within.get(s, 0) for s in
                ("split.edge", "pipeline.quantize", "pipeline.restore",
                 "split.cloud"))
    readings = {k: spec.reader(k)(ctx) for k in READINGS}
    top = {}
    for stage in ("split.edge", "pipeline.restore", "split.cloud"):
        sub = trace.Trace(ops=[o for o, s in zip(tr.ops, tr.launched_by())
                               if s == stage])
        if sub.ops:
            top[stage] = sub.top_ops(8)
    return {
        "completed": done, "window_s": tr.window_s, "busy_s": tr.busy_s,
        "ops": len(tr.ops), "ops_ms_per_request": _per_request(ops_ns, done),
        "unattributed_share": tr.unattributed_share(),
        "edge_quantize_restore_cloud_ms": _per_request(named, done),
        "readings": readings,
        "device_ms_within": {s: _per_request(v, done)
                             for s, v in within.items()},
        "device_ms_innermost": {str(s): _per_request(v, done)
                                for s, v in by_stage.items()},
        "host_ms": {s: v * 1e3 / done for s, v in sorted(host.items())},
        "idle_gaps": tr.idle_gaps(40),
        "top_ops_by_stage": top,
    }


def main(argv=None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cache = root / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    import torch

    from portbench import bench
    from repro_torch.obs import hooks
    from repro_torch.obs.metrics import MetricsRegistry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cell = bench.Cell(args.workload)
    st = bench.Setup(cell, args.seed, device)
    st.window(0.0, trace.spans(False))
    bench.sync(device)
    out = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "setup_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(device),
           "requests_per_s": {}}
    win = st.window(args.seconds, trace.spans(False))
    out["requests_per_s"]["plain"] = win.completed / win.seconds
    registry = MetricsRegistry()
    with hooks.active(registry):
        win = st.window(args.seconds, trace.spans(False))
    out["requests_per_s"]["hooks"] = win.completed / win.seconds
    registry = MetricsRegistry()
    win, tr = profiled(lambda: st.window(args.seconds, trace.spans(True)),
                       registry)
    bench.sync(device)
    out["requests_per_s"]["traced"] = win.completed / win.seconds
    st.release()
    ctx = bench.Context(cell.cfg, cell.traffic, win, tr, registry, 0.0,
                        {}, trace.port_kernels(), cell.family)
    out["traced"] = summary(ctx)
    print(f"unattributed share of device-operation time: "
          f"{100 * out['traced']['unattributed_share']!r}%", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
