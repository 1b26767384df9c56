"""The traced run: ``torch.profiler`` over the window, reduced to device
operations, the benchmark's host spans, busy time and idle gaps.

Host spans are ``record_function`` ranges named ``pb.<stage>`` around each
call into the port; ``pb.window`` spans the whole window. Device
operations are the trace's CUDA events (kernels, copies, memsets).
"""
from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field
from pathlib import Path

PREFIX = "pb."
WINDOW = PREFIX + "window"
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")


def port_kernels() -> dict[str, set[str]]:
    """{source stem: names of its ``__global__`` functions} for every
    ``.cu`` file of the port; empty where the sources are not there."""
    return {p.stem: set(_GLOBAL.findall(p.read_text()))
            for p in sorted(CSRC.glob("*.cu"))}


def base_name(name: str) -> str:
    """A kernel's function name from its demangled device-event name."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip().split("::")[-1]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    ops: list = field(default_factory=list)      # (name, start_ns, end_ns)
    spans: list = field(default_factory=list)    # (name, start_ns, end_ns)
    window: tuple = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of device operations, clipped to the window."""
        w0, w1 = self.window
        out = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def kernel_calls(self, names: set[str]) -> list[float]:
        """Seconds of each device call of a kernel named in ``names``."""
        return [(b - a) / 1e9 for n, a, b in self.ops
                if base_name(n) in names]

    def top_ops(self, n: int = 10) -> list[list]:
        total: dict[str, int] = {}
        for name, a, b in self.ops:
            key = name[:120]
            total[key] = total.get(key, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time by the innermost host span around each gap's
        middle (``host idle`` where the benchmark was in none)."""
        busy = self.busy()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        spans = sorted((s for s in self.spans if s[0] != WINDOW),
                       key=lambda s: s[1])
        starts = [s[1] for s in spans]
        total: dict[str, int] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "host idle"
            # the innermost span holding mid is the latest-starting one;
            # the loops nest spans at most a few deep
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - 4, -1), -1):
                if spans[i][2] > mid:
                    name = spans[i][0]
                    break
            total[name] = total.get(name, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def spans(active: bool):
    """``span(name)`` for the loops: ``record_function`` when traced."""
    if not active:
        null = contextlib.nullcontext()
        return lambda name: null
    from torch.profiler import record_function
    return lambda name: record_function(PREFIX + name)


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` inside a ``pb.window`` span ->
    (its result, :class:`Trace`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    tr = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            if not name.startswith(PREFIX):
                tr.ops.append((name, a, b))
        elif name.startswith(PREFIX):
            tr.spans.append((name[len(PREFIX):] if name != WINDOW else name,
                             a, b))
            if name == WINDOW:
                tr.window = (a, b)
    return out, tr
