"""What every family's window returns, and the closed loop that drives
most of them; each family's windows (its ``window``) read a traffic
file's parameters.

In a closed loop a client sends its next request when the answer to its
last one is on the host. A request's latency runs from when its client
enqueued it to when its answer was on the host; every request sent before
the window's close is served (the loop drains), so the window ends at the
last answer and each request is counted and timed once.

``span(name)`` wraps each call into the port (a no-op context when the run
is not traced; ``torch.profiler.record_function`` when it is); a traced
run's idle gaps are named by these spans.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    attempted: int = 0
    latencies: list = field(default_factory=list)     # seconds
    wire_bytes: int = 0
    frames: list = field(default_factory=list)        # pool entry per answer
    answers: list = field(default_factory=list)       # what the check judges
    batches: list = field(default_factory=list)       # (t_done, answered)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def quarters(self) -> list[float]:
        """Requests a second answered in each quarter of the window."""
        q = self.seconds / 4
        n = [0, 0, 0, 0]
        for t, k in self.batches:
            n[min(3, int((t - self.t0) / q))] += k
        return [x / q for x in n]


def closed_loop(n_clients, batch, seconds, serve, next_frame):
    """Run ``serve(entries) -> (t_done, answers, wire bytes of each)`` on
    batches of ``batch`` queued requests, each carrying the pool entry
    ``next_frame(request index)``, until ``seconds`` have passed, then
    drain the queue. An answer of None is counted and not kept."""
    win = Window()
    queue = deque()
    win.t0 = time.perf_counter()
    deadline = win.t0 + seconds
    for _ in range(n_clients):
        queue.append((next_frame(win.attempted), win.t0))
        win.attempted += 1
    while queue:
        reqs = [queue.popleft() for _ in range(min(batch, len(queue)))]
        t_done, answers, nbytes = serve([f for f, _ in reqs])
        win.batches.append((t_done, len(reqs)))
        for (f, t_enq), ans, n in zip(reqs, answers, nbytes):
            win.latencies.append(t_done - t_enq)
            win.wire_bytes += n
            if ans is not None:
                win.frames.append(f)
                win.answers.append(ans)
        if t_done < deadline:
            for _ in reqs:
                queue.append((next_frame(win.attempted), t_done))
                win.attempted += 1
        win.t1 = t_done
    return win
