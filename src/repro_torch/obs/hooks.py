"""Zero-cost-when-disabled stage timers and observations for library code.

The port's counterpart of ``repro/obs/hooks.py``, with one more sink. The
compression plan, the CNN's halves, the gateway and the rANS codec call
``timed`` / ``observe`` / ``count`` at their stages; a caller that wants
the numbers installs a registry:

    from repro_torch.obs import hooks
    with hooks.timed("pipeline.encode", backend=op.wire_backend):
        ...body...

When no registry is installed (the default), ``timed`` returns one shared
no-op context manager and ``observe``/``count`` return after a single
``is None`` check. With a registry installed, ``timed`` does two things:

* it adds the body's host wall-clock time (``time.perf_counter``) to the
  ``stage_seconds`` histogram labelled ``stage=...``. For a stage that only
  enqueues card work (``pipeline.quantize``, ``.histogram``, ``.restore``)
  that is the enqueue's host time, not the card's;
* it opens a profiler range named after the stage around the body. Under a
  ``torch.profiler`` session the range lands on the profiler's timeline,
  on the same clock as the card's kernels and copies, so each device
  operation can be put down to the stage that launched it (the runtime
  call's correlation id leads from a kernel to its launch on the host) and
  each idle gap on the card to the stage the host was in. The range is a
  host-only operator range: it leaves no mirror on the device's timeline.
  Outside a profiler session it costs one state check.

The virtual-clock ``Tracer`` (``obs/trace.py``) never sees these times.
"""
from __future__ import annotations

import contextlib
import time

# an operator-scope range: recorded on the host thread only, where a
# user-annotation range (torch.profiler.record_function) would also be
# mirrored on the device's timeline as if it were a device operation
from torch._C._profiler import _RecordFunctionFast

from repro_torch.obs.metrics import MetricsRegistry

_REGISTRY: MetricsRegistry | None = None


class _NullTimer:
    """Shared no-op timer handed out when instrumentation is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTimer()


class _StageTimer:
    __slots__ = ("_hist", "_range", "_t0")

    def __init__(self, hist, stage: str):
        self._hist = hist
        self._range = _RecordFunctionFast(stage)
        self._t0 = 0.0

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        self._range.__exit__(*exc)
        return False


def install(registry: MetricsRegistry) -> None:
    """Route stage timers/observations into ``registry`` until uninstall,
    and open a profiler range around each timed stage."""
    global _REGISTRY
    _REGISTRY = registry


def uninstall() -> None:
    global _REGISTRY
    _REGISTRY = None


def installed() -> MetricsRegistry | None:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY is not None


@contextlib.contextmanager
def active(registry: MetricsRegistry):
    """Scoped install (benchmarks, tests): uninstalls on exit, always."""
    install(registry)
    try:
        yield registry
    finally:
        uninstall()


def timed(stage: str, **labels):
    """Context manager timing its body into the ``stage_seconds`` histogram
    labeled ``stage=...`` (wall clock), inside a profiler range named
    ``stage``. No-op when disabled."""
    r = _REGISTRY
    if r is None:
        return _NULL
    return _StageTimer(r.histogram("stage_seconds", stage=stage, **labels),
                       stage)


def observe(name: str, value: float, **labels) -> None:
    """Record one histogram observation (lane occupancy, batch widths)."""
    r = _REGISTRY
    if r is not None:
        r.histogram(name, **labels).observe(value)


def count(name: str, value: float = 1.0, **labels) -> None:
    """Bump a counter. No-op when disabled."""
    r = _REGISTRY
    if r is not None:
        r.counter(name, **labels).inc(value)
