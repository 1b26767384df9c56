"""Loss recovery for streaming sessions: desync detection and NACK timing.

Copy of ``repro/session/recovery.py`` for the port (pure host code).

The session codec (repro_torch/session/codec.py) guarantees *detection*: a
lost or corrupt frame makes the decoder raise instead of restoring wrong
codes. This module owns what happens next — the desync/NACK/intra-refresh
state machine and its timing bound:

  1. the decoder hits :class:`~repro_torch.session.codec.SessionDesync` (or
     :class:`~repro_torch.codec.rans.CorruptStream`) and the tracker enters
     desync,
  2. a NACK travels the simulated downlink (``nack_latency_s``),
  3. the encoder's next frame after the NACK lands is a forced I-frame,
  4. that I-frame crosses the lossy uplink; when it decodes, the tracker
     records first-desync -> resync as one recovery interval.

If the I-frame itself is lost the cycle repeats, so the *expected* recovery
time under loss probability ``p`` scales the single-cycle bound by
``1 / (1 - p)``. A periodic ``keyframe_interval`` bounds recovery even with
NACKs disabled (broadcast-style downlinks): the decoder waits at most one
keyframe period.

Everything here runs on the virtual clock — no wall time, fully
deterministic under seeded channels.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class RecoveryConfig:
    """How a session recovers from desync.

    nack : decoder NACKs on the downlink; encoder answers with intra refresh
    nack_latency_s : one-way downlink latency of the NACK signal
    keyframe_interval : periodic forced I-frame every N frames (0 = none);
        the no-feedback recovery path, also useful as a belt alongside NACKs
        on very lossy links
    """
    nack: bool = True
    nack_latency_s: float = 0.02
    keyframe_interval: int = 0

    def __post_init__(self):
        if self.nack_latency_s < 0:
            raise ValueError("nack_latency_s must be >= 0")
        if self.keyframe_interval < 0:
            raise ValueError("keyframe_interval must be >= 0")
        if not self.nack and self.keyframe_interval == 0:
            raise ValueError(
                "unrecoverable session: NACKs disabled and no periodic "
                "keyframes — a single lost frame would desync forever")


@dataclass
class RecoveryTracker:
    """Measures desync episodes on the virtual clock.

    One *episode* spans from the first desync event (later desyncs while
    already down do not restart the clock — the session is simply still
    down) to the resync that ends it. ``max_recovery_s`` is the quantity the
    tests bound against :func:`recovery_bound_s`.
    """
    in_desync: bool = False
    desync_since: float = 0.0
    episodes: int = 0
    desync_events: int = 0
    recovery_times: list = field(default_factory=list)

    def on_desync(self, t: float) -> bool:
        """Register a desync at virtual time ``t``; True when this event
        *opened* an episode (i.e. a NACK should be scheduled)."""
        self.desync_events += 1
        if self.in_desync:
            return False
        self.in_desync = True
        self.desync_since = t
        self.episodes += 1
        return True

    def on_resync(self, t: float) -> None:
        """An I-frame decoded at ``t``: close the episode if one is open."""
        if not self.in_desync:
            return
        self.in_desync = False
        self.recovery_times.append(t - self.desync_since)

    @property
    def max_recovery_s(self) -> float:
        return max(self.recovery_times, default=0.0)

    @property
    def mean_recovery_s(self) -> float:
        if not self.recovery_times:
            return 0.0
        return sum(self.recovery_times) / len(self.recovery_times)


def recovery_bound_s(*, fps: float, uplink_latency_s: float,
                     nack_latency_s: float, margin_frames: int = 2) -> float:
    """Analytic single-cycle recovery bound for the NACK path.

    Worst case, measured from the desync *detection* instant (a successor
    frame arriving and failing to chain):

      * the NACK crosses the downlink        -> ``nack_latency_s``
      * the encoder waits for its next frame -> up to ``1 / fps``
      * the forced I-frame crosses the uplink-> ``uplink_latency_s``

    plus ``margin_frames`` frame intervals of slack for queueing on a busy
    uplink (frames already in flight ahead of the refresh) and the
    half-open event ordering of the simulator. Callers dealing with loss
    probability ``p`` should scale by ``1 / (1 - p)`` cycles on average.
    """
    if fps <= 0:
        raise ValueError("fps must be > 0")
    frame_s = 1.0 / fps
    return nack_latency_s + frame_s + uplink_latency_s \
        + margin_frames * frame_s
