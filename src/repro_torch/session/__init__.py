"""Streaming sessions: temporal BaF delta coding over the plan/serve stack.

Counterpart of ``repro.session`` on the port's gateway and plans.

BaF prediction exploits redundancy *within* one tensor; a camera feeding the
split network at 10-30 fps also carries redundancy *between* consecutive
frames' feature tensors. This package adds the stateful layer that captures
it:

  * :mod:`repro_torch.session.codec` — per-session reference state and the
    SessionFrame wire format: I-frames are today's ``CompressionPlan.encode``
    containers unchanged; P-frames code the temporal delta of quantized
    codes through the same entropy backends, wrapped in a versioned,
    CRC-hardened frame header (session id, frame seq, reference seq, I/P
    flag).
  * :mod:`repro_torch.session.recovery` — the desync/NACK/intra-refresh
    state machine: a lost or corrupt frame can never be silently restored;
    the decoder desyncs, NACKs on the simulated downlink, and the encoder
    answers with a forced I-frame, bounding recovery time.
  * :mod:`repro_torch.session.manager` — many concurrent camera sessions on
    the virtual clock through ``MultiTenantGateway``'s executor/batcher
    machinery, with per-session QoS: under overload a session steps down
    the quality ladder (coarser OperatingPoint, sparser cadence) *before*
    admission sheds it, metered as a distinct telemetry outcome.

See docs/STREAMING.md for the wire format and the recovery bounds.
"""
from repro_torch.session.codec import (SESSION_MAGIC, FrameMeta,
                                       SessionConfig, SessionDecoder,
                                       SessionDesync, SessionEncoder,
                                       SessionError, SessionFrame)
from repro_torch.session.manager import (QosLevel, SessionManager,
                                         SessionSpec, StreamReport)
from repro_torch.session.recovery import (RecoveryConfig, RecoveryTracker,
                                          recovery_bound_s)

__all__ = [
    "SESSION_MAGIC", "FrameMeta", "SessionConfig", "SessionDecoder",
    "SessionDesync", "SessionEncoder", "SessionError", "SessionFrame",
    "QosLevel", "SessionManager", "SessionSpec", "StreamReport",
    "RecoveryConfig", "RecoveryTracker", "recovery_bound_s",
]
