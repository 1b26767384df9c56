"""Declarative operating points for the BaF compression pipeline.

Copy of ``repro/pipeline/op.py`` for the port (operating points,
capabilities, and the negotiation of operating points, session profiles
and task heads).

An :class:`OperatingPoint` is the single value object that names *everything*
about how one request's split activation is coded on the wire: how many
channels travel (C), the quantizer depth (n), which entropy backend codes the
stream, whether the channels are tiled into a 2D image first, which context
model the coder runs, and which wire-profile generation the container speaks.

``auto`` fields resolve from the backend registry (``resolve()``), so callers
write ``OperatingPoint(c=8, bits=6, backend="rans")`` and the pipeline fills
in the tiling detour and context mode the backend needs.

Capability negotiation lets a gateway refuse — or, when allowed, downgrade —
an operating point whose wire profile or backend it does not speak, instead
of failing deep inside the codec on the cloud side.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Wire-profile generation: bumped with the container magic (core/codec.py
# writes BaF2). A gateway advertises the profiles it can decode; encode and
# decode sides must agree before any bytes move.
WIRE_PROFILE_VERSION = 2

# Streaming-session wire profile: the SessionFrame framing that wraps I/P
# frames (repro_torch.session.codec writes SSF1). Negotiated separately from
# the container profile — an endpoint may decode plain containers but not
# speak the temporal-delta framing, in which case sessions fall back to
# I-only.
SESSION_WIRE_VERSION = 1

_TILING_MODES = ("auto", "tiled", "direct")
_CONTEXT_MODES = ("auto", "none", "static", "adaptive")


class NegotiationError(ValueError):
    """The gateway cannot serve this operating point and may not downgrade."""


@dataclass(frozen=True)
class OperatingPoint:
    """One coding configuration, end to end.

    c        : transmitted channels (power of two; tiling constraint)
    bits     : quantizer depth n
    backend  : entropy backend family ('zlib' | 'png' | 'raw' | 'rans' | ...)
    tiling   : 'auto' resolves from the backend ('tiled' = 2D image detour,
               'direct' = channel-last tensor coded as-is)
    context  : 'auto' resolves from the backend; 'adaptive' upgrades 'rans'
               to the context-adaptive coder ('rans-ctx' on the wire)
    profile  : wire-profile generation this point's containers speak
    """
    c: int
    bits: int
    backend: str = "zlib"
    tiling: str = "auto"
    context: str = "auto"
    profile: int = WIRE_PROFILE_VERSION

    def __post_init__(self):
        if self.c < 1:
            raise ValueError(f"c must be >= 1, got {self.c}")
        if not 1 <= self.bits <= 16:
            raise ValueError(f"bits must be in 1..16, got {self.bits}")
        if self.tiling not in _TILING_MODES:
            raise ValueError(f"tiling must be one of {_TILING_MODES}, "
                             f"got {self.tiling!r}")
        if self.context not in _CONTEXT_MODES:
            raise ValueError(f"context must be one of {_CONTEXT_MODES}, "
                             f"got {self.context!r}")

    # -- resolution ---------------------------------------------------------
    @property
    def wire_backend(self) -> str:
        """Registry name of the backend that actually codes the stream.

        ``context='adaptive'`` upgrades the static 'rans' family to the
        context-adaptive coder; every other combination passes through.
        """
        if self.backend == "rans" and self.context == "adaptive":
            return "rans-ctx"
        return self.backend

    def resolve(self) -> "OperatingPoint":
        """Fill every ``auto`` field from the backend registry."""
        from repro_torch.core import codec as wire
        tiling = self.tiling
        if tiling == "auto":
            tiling = ("tiled" if wire.backend_wants_tiling(self.wire_backend)
                      else "direct")
        if tiling == "tiled" and (self.c & (self.c - 1)) != 0:
            raise ValueError(
                f"backend {self.wire_backend!r} tiles the channels into a 2D "
                f"image, which requires a power-of-two C (got {self.c}); "
                f"use a direct backend such as 'rans' for this C")
        context = self.context
        if context == "auto":
            context = {"rans": "static", "rans-ctx": "adaptive"}.get(
                self.backend, "none")
        if tiling == self.tiling and context == self.context:
            return self
        return dataclasses.replace(self, tiling=tiling, context=context)

    def with_backend(self, backend: str) -> "OperatingPoint":
        """Same point on a different backend; tiling/context re-resolve."""
        if backend == self.backend:
            return self
        return dataclasses.replace(self, backend=backend, tiling="auto",
                                   context="auto")


@dataclass(frozen=True)
class Capabilities:
    """What one gateway (or decoder) can speak.

    profiles  : wire-profile generations the decode side understands
    backends  : entropy backends it can decode (None = everything registered);
                order matters — the first entry is the downgrade target
    max_bits  : deepest quantizer it will decode
    downgrade : whether :func:`negotiate` may substitute a supported backend
                / shallower bit depth instead of refusing
    session_profiles : SessionFrame framing generations the decode side
                speaks (empty tuple = no temporal P-frames; sessions run
                I-only when downgrade is allowed)
    task_heads : downstream task heads this endpoint serves (None = every
                registered head; see repro_torch.tasks.heads). A declared
                task the endpoint does not serve is dropped when downgrade
                is allowed, refused otherwise (:func:`negotiate_tasks`)
    """
    profiles: tuple = (WIRE_PROFILE_VERSION,)
    backends: tuple | None = None
    max_bits: int = 16
    downgrade: bool = True
    session_profiles: tuple = (SESSION_WIRE_VERSION,)
    task_heads: tuple | None = None

    def serves_task(self, name: str) -> bool:
        return self.task_heads is None or name in self.task_heads

    def speaks_backend(self, name: str) -> bool:
        return self.backends is None or name in self.backends


def negotiate(op: OperatingPoint, caps: Capabilities | None) -> OperatingPoint:
    """Fit ``op`` to ``caps``: pass through, downgrade, or refuse.

    A wire-profile mismatch always refuses — there is no lower profile to
    fall back to, the container format itself is foreign. Backend and bit
    depth downgrade to the capabilities' preferred backend / max depth when
    ``caps.downgrade`` allows it, otherwise raise :class:`NegotiationError`.
    """
    if caps is None:
        return op
    if op.profile not in caps.profiles:
        raise NegotiationError(
            f"gateway speaks wire profiles {caps.profiles}, operating point "
            f"requires profile {op.profile}")
    out = op
    if not caps.speaks_backend(out.wire_backend):
        if not caps.downgrade or not caps.backends:
            raise NegotiationError(
                f"gateway cannot decode backend {out.wire_backend!r} "
                f"(speaks {caps.backends}) and downgrade is disabled")
        # full re-base, context included: downgrading 'rans'+adaptive to
        # plain 'rans' must also drop the context upgrade that made the
        # wire backend unsupported in the first place
        out = dataclasses.replace(out, backend=caps.backends[0],
                                  tiling="auto", context="auto")
    if out.bits > caps.max_bits:
        if not caps.downgrade:
            raise NegotiationError(
                f"gateway decodes at most {caps.max_bits} bits, operating "
                f"point requires {out.bits}")
        out = dataclasses.replace(out, bits=caps.max_bits)
    try:
        # negotiation promises a servable point: a downgrade that lands on
        # a backend unable to code this C (e.g. rans C=12 -> tiled zlib,
        # which needs a power-of-two C) must refuse here, not blow up with
        # a ValueError at plan-compile time
        out.resolve()
    except ValueError as e:
        raise NegotiationError(
            f"no supported backend can serve this operating point: {e}"
        ) from None
    return out


def negotiate_session(caps: Capabilities | None, *,
                      profile: int = SESSION_WIRE_VERSION) -> bool:
    """Can a session stream temporal P-frames at this endpoint?

    True = the decode side speaks the SessionFrame profile, P-frames may
    flow. False = it does not, but downgrade is allowed, so the session runs
    I-frame-only (every frame a standalone container — correct, just more
    bits). Refusal (profile unknown AND downgrade disabled) raises
    :class:`NegotiationError` before any frame is encoded.
    """
    if caps is None or profile in caps.session_profiles:
        return True
    if caps.downgrade:
        return False
    raise NegotiationError(
        f"endpoint speaks session profiles {caps.session_profiles}, stream "
        f"requires profile {profile} and downgrade is disabled")


def negotiate_tasks(tasks, caps: Capabilities | None) -> tuple:
    """Fit a tenant's declared task set to the endpoint's served heads.

    Returns the effective task tuple (declaration order kept, duplicates
    dropped). A declared head the endpoint does not serve is dropped when
    ``caps.downgrade`` allows it — the tenant is served the subset and,
    through bit allocation, only pays for that subset; with downgrade
    disabled, or when nothing declared survives, the whole declaration is
    refused (:class:`NegotiationError`). Task negotiation never touches the
    operating point — wire-profile and backend fitting stay in
    :func:`negotiate`, so a foreign wire profile still refuses regardless
    of how few heads a tenant declares.
    """
    declared = tuple(dict.fromkeys(tasks))
    if not declared:
        raise ValueError("empty task declaration (declare at least one "
                         "task head)")
    if caps is None or caps.task_heads is None:
        return declared
    served = tuple(t for t in declared if t in caps.task_heads)
    if served == declared:
        return declared
    dropped = [t for t in declared if t not in caps.task_heads]
    if not caps.downgrade:
        raise NegotiationError(
            f"endpoint serves task heads {sorted(caps.task_heads)}, tenant "
            f"declared unsupported {dropped} and downgrade is disabled")
    if not served:
        raise NegotiationError(
            f"endpoint serves task heads {sorted(caps.task_heads)}; none of "
            f"the declared tasks {list(declared)} can be served")
    return served
