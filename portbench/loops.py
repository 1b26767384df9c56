"""The measured window of each traffic kind, one general driver per kind
read from a traffic file's parameters.

Every kind is a closed loop: a client sends its next request when the
answer to its last one is on the host. A request's latency runs from when
its client enqueued it to when its answer was on the host; every request
sent before the window's close is served (the loop drains), so the window
ends at the last answer and each request is counted and timed once.

``span(name)`` wraps each call into the port (a no-op context when the run
is not traced; ``torch.profiler.record_function`` when it is).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from portbench import system


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    attempted: int = 0
    latencies: list = field(default_factory=list)     # seconds
    wire_bytes: int = 0
    frames: list = field(default_factory=list)        # pool index per answer
    answers: list = field(default_factory=list)       # logits rows or blobs
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


def _closed_loop(n_clients, batch, seconds, serve, next_frame):
    """Run ``serve(frames) -> (t_done, answers, wire bytes of each)`` on
    batches of ``batch`` queued requests until ``seconds`` have passed,
    then drain the queue."""
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


def cloud_closed_loop(prog, traffic, pool_blobs, schedule, seconds, span):
    """decode_batch -> restore (consolidate kernel) -> cloud -> logits on
    the host, a micro-batch at a time, as ``ServingGateway._run_batch``."""
    plan, batch = prog.plan, traffic["batch"]

    def serve(frames):
        with span("decode_batch"):
            decoded = plan.decode_batch([pool_blobs[f] for f in frames])
        with span("restore"):
            z = plan.restore(decoded.pad_to(batch))
        with span("cloud"):
            out = prog.cloud(z)
        with span("to_host"):
            logits = out.cpu().numpy()
        return (time.perf_counter(), logits[:len(frames)],
                [pool_blobs[f].nbytes for f in frames])

    return _closed_loop(traffic["outstanding"], batch, seconds, serve,
                        lambda i: int(schedule.frame[i]))


def edge_closed_loop(prog, traffic, frames_host, schedule, seconds, span,
                     device):
    """Each frame: to the device, edge CNN at B=1, ``plan.encode`` (the
    quantize kernel, one copy, packing) to wire bytes on the host, as
    ``ServingGateway.encode_request``. The blobs of ``schedule.keep``'s
    requests are kept for the check."""
    plan = prog.plan
    index = [0]

    def serve(frames):
        (f,) = frames
        i = index[0]
        index[0] += 1
        with span("to_device"):
            x = system.to_device(frames_host[f:f + 1], device)
        with span("edge"):
            z = prog.edge(x)
        with span("encode"):
            blob = plan.encode(z)
        keep = blob.data if schedule.keep[i] else None
        return time.perf_counter(), [keep], [blob.nbytes]

    return _closed_loop(traffic["clients"], 1, seconds, serve,
                        lambda i: int(schedule.frame[i]))


def gateway_serve(prog, traffic, frames_host, seconds, span):
    """``ServingGateway.serve`` on ``frames_per_call`` frames at a time, the
    pool's groups in turn, until ``seconds`` have passed (at least one
    call); all of a call's requests are enqueued when it starts and
    answered when it returns."""
    per = traffic["frames_per_call"]
    groups = frames_host.shape[0] // per
    win = Window()
    win.t0 = time.perf_counter()
    deadline = win.t0 + seconds
    call = 0
    while True:
        g = call % groups
        t_enq = time.perf_counter()
        with span("serve"):
            responses, _ = prog.gateway.serve(frames_host[g * per:
                                                          (g + 1) * per])
        t = time.perf_counter()
        win.batches.append((t, per))
        for j, r in enumerate(responses):
            win.latencies.append(t - t_enq)
            win.wire_bytes += r.stats.wire_bits // 8
            win.frames.append(g * per + j)
            win.answers.append(np.asarray(r.logits))
        win.attempted += per
        call += 1
        if t >= deadline:
            break
    win.t1 = t
    return win
