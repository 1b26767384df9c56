"""Virtual-clock span traces for the serving gateway, exported as
Chrome/Perfetto trace-event JSON.

Copy of ``repro/obs/trace.py`` for the port: the same spans give the same
bytes in both packages.

Every span is keyed to the gateway's **virtual clock** (channel / scheduler /
executor times), never to the wall clock. Under a deterministic cost model
(``LinearCostModel``) the virtual clock depends only on the workload, so two
runs of the same workload export **byte-identical** trace JSON — the same
replay property the telemetry has, extended to traces. Wall-time
stage measurements (how long host decode actually took) belong in
:mod:`repro_torch.obs.metrics` histograms via :mod:`repro_torch.obs.hooks`;
putting them in a trace would destroy determinism.

Span taxonomy (see docs/OBSERVABILITY.md):

  ``request``          per served request, spanning submit->response; children
                       partition it exactly:
  ``sched.wait``         encode done -> uplink grant (DRR scheduler)
  ``channel.transmit``   uplink grant -> arrival at the cloud
  ``exec.queue``         arrival -> executor service start
  ``cloud.compute``      executor service (batched decode+restore+forward)
  ``exec.batch``       per executor ticket, on its queue's own track
  instants: ``submit``, ``edge.encode``, ``admission.shed``

The per-request children are built from the *same* floats the telemetry
record holds, summed in the same order — so per-request span durations
reconcile with ``RequestRecord.total_latency_s`` exactly (0 ulp), and the
<1e-9 s acceptance bound holds trivially. :func:`reconcile_trace` checks it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

_US = 1e6          # trace-event timestamps are microseconds


@dataclass
class Span:
    span_id: int
    name: str
    t0: float                     # virtual seconds
    t1: float
    track: str                    # display track (maps to a Perfetto tid)
    parent: int | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclass
class Instant:
    name: str
    t: float
    track: str
    attrs: dict = field(default_factory=dict)


class Tracer:
    """Collects spans/instants on the virtual clock; exports trace-event JSON.

    Deterministic by construction: span ids are assignment-ordered, tracks
    get tids in first-use order, attributes are sorted at export, and the
    JSON dump is canonical (sorted keys, fixed separators). Emission is a
    couple of appends — cheap enough to leave on in benchmarks (the JAX
    package's overhead gate in benchmarks/serve_gateway.py pins this).
    """

    def __init__(self, *, process_name: str = "repro-gateway"):
        self.process_name = process_name
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self._children: dict[int, list[int]] = {}
        self._tids: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.spans)

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
        return tid

    # -- emission ------------------------------------------------------------
    def span(self, name: str, t0: float, t1: float, *, track: str = "gateway",
             parent: int | None = None, **attrs) -> int:
        """Record a closed span [t0, t1]; returns its id (usable as parent)."""
        sid = len(self.spans)
        self.spans.append(Span(span_id=sid, name=name, t0=float(t0),
                               t1=float(t1), track=track, parent=parent,
                               attrs=attrs))
        self._tid(track)
        if parent is not None:
            self._children.setdefault(parent, []).append(sid)
        return sid

    def instant(self, name: str, t: float, *, track: str = "gateway",
                **attrs) -> None:
        """Record a point event (submission, shed, encode-done)."""
        self.instants.append(Instant(name=name, t=float(t), track=track,
                                     attrs=attrs))
        self._tid(track)

    # -- structure -----------------------------------------------------------
    def children(self, span_id: int) -> list[Span]:
        return [self.spans[i] for i in self._children.get(span_id, [])]

    def roots(self, name: str | None = None) -> list[Span]:
        return [s for s in self.spans if s.parent is None
                and (name is None or s.name == name)]

    def validate(self, *, eps: float = 0.0) -> None:
        """Span-tree invariants: durations non-negative, parents exist,
        children nest inside their parents. Raises ValueError on violation."""
        n = len(self.spans)
        for s in self.spans:
            if s.t1 < s.t0:
                raise ValueError(f"span {s.span_id} ({s.name}): "
                                 f"t1 {s.t1} < t0 {s.t0}")
            if s.parent is not None:
                if not 0 <= s.parent < n:
                    raise ValueError(f"span {s.span_id} ({s.name}): "
                                     f"unknown parent {s.parent}")
                p = self.spans[s.parent]
                if s.t0 < p.t0 - eps or s.t1 > p.t1 + eps:
                    raise ValueError(
                        f"span {s.span_id} ({s.name}) "
                        f"[{s.t0}, {s.t1}] escapes parent "
                        f"{p.span_id} ({p.name}) [{p.t0}, {p.t1}]")

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome/Perfetto trace-event JSON object (load via chrome://tracing
        or ui.perfetto.dev). Timestamps are virtual-clock microseconds."""
        events: list[dict] = []
        pid = 1
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": self.process_name}})
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
        for s in self.spans:
            args = {k: s.attrs[k] for k in sorted(s.attrs)}
            args["span_id"] = s.span_id
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({"ph": "X", "pid": pid, "tid": self._tids[s.track],
                           "name": s.name, "cat": "virtual",
                           "ts": s.t0 * _US, "dur": (s.t1 - s.t0) * _US,
                           "args": args})
        for i in self.instants:
            events.append({"ph": "i", "pid": pid, "tid": self._tids[i.track],
                           "name": i.name, "cat": "virtual", "s": "t",
                           "ts": i.t * _US,
                           "args": {k: i.attrs[k] for k in sorted(i.attrs)}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Canonical JSON: identical virtual clocks => identical bytes."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def validate_chrome_trace(obj) -> int:
    """Structural validation of a trace-event JSON object (the format
    chrome://tracing / Perfetto ingests). Returns the event count; raises
    ValueError with a specific complaint otherwise."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents array")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be an array")
    for k, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {k}: not an object")
        for field_name in ("ph", "name", "pid", "tid"):
            if field_name not in ev:
                raise ValueError(f"event {k}: missing {field_name!r}")
        ph = ev["ph"]
        if ph == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"event {k}: complete event needs ts+dur")
            if ev["dur"] < 0:
                raise ValueError(f"event {k}: negative duration {ev['dur']}")
        elif ph == "i":
            if "ts" not in ev:
                raise ValueError(f"event {k}: instant event needs ts")
        elif ph != "M":
            raise ValueError(f"event {k}: unsupported phase {ph!r}")
    return len(events)


def reconcile_trace(tracer: Tracer, telemetry) -> float:
    """Max |sum(child span durations) - total_latency_s| over all served
    records. Every telemetry record must have a matching ``request`` span
    (keyed by tenant + req_id) whose children partition it; raises if one
    is missing. The acceptance bound is < 1e-9 s; by construction (same
    floats, same summation order) the error is exactly 0.0."""
    sums: dict[tuple, float] = {}
    for root in tracer.roots("request"):
        kids = sorted(tracer.children(root.span_id),
                      key=lambda s: (s.t0, s.span_id))
        if not kids:
            raise ValueError(f"request span {root.span_id} has no children")
        total = 0.0
        for s in kids:
            total += s.t1 - s.t0
        sums[(root.attrs.get("tenant"), root.attrs.get("req_id"))] = total
    err = 0.0
    for rec in telemetry.records:
        key = (rec.tenant, rec.req_id)
        if key not in sums:
            raise ValueError(f"no request span for tenant={rec.tenant!r} "
                             f"req_id={rec.req_id}")
        err = max(err, abs(sums[key] - rec.total_latency_s))
    return err
