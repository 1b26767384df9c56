"""Runtime replay sanitizer: dynamic coverage behind the static rules.

The static pass (RA01/RA02) proves no *call site* in the scoped modules
reads a wall clock or legacy RNG; this context manager proves no *code
path* does, by patching the entry points to raise for the duration of a
replay run::

    from repro_torch.analysis import replay_sanitizer

    with replay_sanitizer():
        _, report = manager.run(frames)        # raises on time.time() etc.
    assert report.signature() == expected

What is patched by default:

  * ``time.time/time_ns/monotonic/monotonic_ns/process_time/process_time_ns``
    — the clocks that would leak wall time into virtual-clock state;
  * the legacy global-state numpy RNG (``np.random.rand/randint/seed/...``
    and ``np.random.random``) and the stdlib ``random`` module functions —
    process-global entropy that would desynchronize replays.

``time.perf_counter`` is deliberately NOT patched by default: it is the
sanctioned measurement clock at the RA01-allowlisted sites (the gateway
warm-timing helpers, ``obs/hooks.py``) which legitimately run inside a
replay — their readings feed measured-cost telemetry, never replayed
state. Pass ``strict=True`` to forbid it too (useful when replaying under
``LinearCostModel``/frozen ``CalibratedCostModel``, where nothing should
measure at all).

Explicit-state APIs — ``np.random.default_rng``, ``np.random.Generator``,
``random.Random(seed)`` instances, ``jax.random`` — keep working: seeded
streams are exactly what replay relies on.
"""
from __future__ import annotations

import random as _py_random
import time as _time
from contextlib import contextmanager

import numpy as _np

__all__ = ["ReplaySanitizerError", "replay_sanitizer"]


class ReplaySanitizerError(RuntimeError):
    """A forbidden wall-clock / global-RNG entry point fired during a
    sanitized replay run."""


_TIME_FNS = ("time", "time_ns", "monotonic", "monotonic_ns",
             "process_time", "process_time_ns")
_STRICT_TIME_FNS = ("perf_counter", "perf_counter_ns")
_NP_RANDOM_FNS = ("random", "rand", "randn", "randint", "random_sample",
                  "ranf", "sample", "choice", "shuffle", "permutation",
                  "uniform", "normal", "standard_normal", "seed",
                  "get_state", "set_state")
_PY_RANDOM_FNS = ("random", "randint", "randrange", "choice", "choices",
                  "shuffle", "sample", "uniform", "gauss", "normalvariate",
                  "betavariate", "expovariate", "seed", "getrandbits")


def _forbid(qualname: str, hint: str):
    def _raise(*args, **kwargs):
        raise ReplaySanitizerError(
            f"{qualname}() called during a sanitized replay run; {hint} "
            f"(rules RA01/RA02, docs/ANALYSIS.md)")
    _raise.__name__ = f"forbidden_{qualname.replace('.', '_')}"
    return _raise


@contextmanager
def replay_sanitizer(*, strict: bool = False):
    """Patch wall-clock + legacy-RNG entry points to raise; restore on exit.

    strict : also forbid ``time.perf_counter`` — only for replays where even
             the allowlisted measurement sites must stay cold (frozen cost
             models).
    """
    patched: list[tuple[object, str, object]] = []

    def patch(mod, name: str, hint: str) -> None:
        original = getattr(mod, name, None)
        if original is None:                 # pragma: no cover - numpy skew
            return
        patched.append((mod, name, original))
        setattr(mod, name, _forbid(f"{mod.__name__}.{name}", hint))

    clock_hint = ("replay paths must read the event-loop virtual clock; "
                  "wall measurement belongs only at allowlisted sites "
                  "using time.perf_counter")
    rng_hint = ("thread an explicitly seeded np.random.Generator / "
                "random.Random through instead")
    fns = _TIME_FNS + (_STRICT_TIME_FNS if strict else ())
    for name in fns:
        patch(_time, name, clock_hint)
    for name in _NP_RANDOM_FNS:
        patch(_np.random, name, rng_hint)
    for name in _PY_RANDOM_FNS:
        patch(_py_random, name, rng_hint)
    try:
        yield
    finally:
        for mod, name, original in reversed(patched):
            setattr(mod, name, original)
