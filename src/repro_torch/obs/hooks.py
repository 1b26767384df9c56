"""Zero-cost-when-disabled stage timers and observations for library code.

Copy of ``repro/obs/hooks.py`` for the port. The compression plan and the
rANS codec call ``timed`` / ``observe`` / ``count`` at their stages; a
caller that wants the numbers installs a registry:

    from repro_torch.obs import hooks
    with hooks.timed("pipeline.encode", backend=op.wire_backend):
        ...body...

When no registry is installed (the default), ``timed`` returns one shared
no-op context manager and ``observe``/``count`` return after a single
``is None`` check. Durations are host wall clock (``time.perf_counter``)
and go only into metrics histograms; they say nothing of work still
queued on the card unless the caller synchronises.
"""
from __future__ import annotations

import contextlib
import time

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
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


def install(registry: MetricsRegistry) -> None:
    """Route stage timers/observations into ``registry`` until uninstall."""
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
    labeled ``stage=...`` (wall clock). No-op when disabled."""
    r = _REGISTRY
    if r is None:
        return _NULL
    return _StageTimer(r.histogram("stage_seconds", stage=stage, **labels))


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
