"""Fault-tolerance policy of the training launcher: a per-step deadline and
cooperative preemption.

Counterpart of ``repro/train/fault.py``, whose classes import nothing of
JAX and are copied here as they are. What the launcher builds from them
(``launch/train.py``):

  * auto-resume: the launcher restores the newest complete checkpoint
    (``train/checkpoint.py``: atomic writes, newest-complete restore,
    retention) and the token stream is a pure function of (seed, step), so
    a restarted job replays the exact batch sequence;
  * a watchdog that wraps the step function with a deadline and turns a
    hang into a clean checkpoint-and-exit (the single-host analogue of the
    straggler escape hatch);
  * SIGTERM sets a flag; the loop checkpoints at the next step boundary
    and exits 0, for a clean requeue.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable


class StepDeadlineExceeded(RuntimeError):
    pass


@dataclass
class Watchdog:
    """Per-step deadline: k x running-median wall time (min_floor seconds).

    Call ``guard(fn)`` around the blocking step; on overrun raises
    StepDeadlineExceeded, which launch/train.py turns into
    checkpoint-and-exit (the cluster runner then reschedules).
    SIGALRM-based, so the main thread of one host only.
    """
    factor: float = 5.0
    min_floor: float = 30.0
    history: list = field(default_factory=list)

    def _deadline(self) -> float:
        if not self.history:
            return max(self.min_floor, 300.0)
        med = sorted(self.history)[len(self.history) // 2]
        return max(self.min_floor, self.factor * med)

    def guard(self, fn: Callable, *args, **kwargs):
        deadline = self._deadline()

        def _raise(signum, frame):
            raise StepDeadlineExceeded(f"step exceeded {deadline:.1f}s")

        old = signal.signal(signal.SIGALRM, _raise)
        signal.setitimer(signal.ITIMER_REAL, deadline)
        t0 = time.monotonic()
        try:
            out = fn(*args, **kwargs)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, old)
        self.history.append(time.monotonic() - t0)
        if len(self.history) > 64:
            self.history.pop(0)
        return out


@dataclass
class PreemptionFlag:
    """Cooperative preemption: SIGTERM sets a flag; the train loop checkpoints
    at the next step boundary and exits 0 (clean requeue)."""
    triggered: bool = False

    def install(self):
        def _handler(signum, frame):
            self.triggered = True
        signal.signal(signal.SIGTERM, _handler)
        return self
