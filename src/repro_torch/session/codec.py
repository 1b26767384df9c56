"""Stateful session codec: temporal delta coding of quantized BaF codes.

Counterpart of ``repro/session/codec.py``; the frames are byte-identical to
the JAX package's for the same codes. The encoder runs on the plan's device:
it quantizes with the quantize kernel, keeps the reference codes on the
card, forms a P-frame's delta there and counts the I-frame's codes or the
P-frame's delta with the histogram kernel; codes, side info and counts come
to the host in one copy (``CompressionPlan.encode_device_codes``). The
decoder's reconstruction runs on the host, as in the JAX package.

Wire format (all little-endian), mirroring the RTC1 container's CRC
discipline (repro_torch/codec/container.py)::

    header  "SSF1" | u8 version | u8 frame_type (0=I, 1=P) | u8 level |
            u8 reserved | u32 session_id | u32 frame_seq | u32 ref_seq |
            u32 payload_len | u32 crc32(header fields above)
    payload <payload_len bytes>   # a BaF2 container (core/codec.py)
    footer  u32 crc32(payload)

An **I-frame**'s payload is exactly today's ``CompressionPlan.encode``
container — a session of keyframes only is byte-compatible with stateless
serving. A **P-frame**'s payload is the same container format over the
*temporal delta* of quantized codes::

    delta = (codes_t - codes_ref) mod 2^bits

entropy-coded by the plan's backend (rANS static tables adapt to the
delta's near-zero concentration, which is where the P-frame bit savings
come from). Reconstruction inverts the delta exactly, so a P-frame decodes
to bit-identical codes as the I-frame it chains from — temporal prediction
is lossless on top of quantization, and restore quality never drifts with
chain length.

The payload CRC means corruption anywhere in the frame is *detected* —
header flips fail the header CRC, payload flips fail the payload CRC —
before any codes are reconstructed. A corrupt or missing frame therefore
never silently restores; the decoder raises (:class:`CorruptStream` /
:class:`SessionDesync`) and the recovery layer
(repro_torch/session/recovery.py) NACKs for an intra refresh.

``level`` names the operating point out of the session's agreed QoS ladder
(:class:`SessionConfig.levels`), so both ends resolve coding parameters
from one byte instead of re-negotiating per frame; a level change forces an
I-frame (a delta across operating points is meaningless).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.codec.rans import CorruptStream
from repro_torch.core.codec import EncodedTensor
from repro_torch.pipeline import (SESSION_WIRE_VERSION, Capabilities,
                                  DecodedBatch, OperatingPoint,
                                  blob_from_tensor, negotiate_session)

SESSION_MAGIC = b"SSF1"

FRAME_I = 0
FRAME_P = 1

_HEADER = struct.Struct("<4sBBBBIIII")
_CRC = struct.Struct("<I")
HEADER_BYTES = _HEADER.size + _CRC.size      # through the header CRC
FRAME_OVERHEAD_BYTES = HEADER_BYTES + _CRC.size


class SessionError(Exception):
    """Base for session-layer failures that are not byte corruption."""


class SessionDesync(SessionError):
    """A P-frame arrived whose reference the decoder does not hold.

    The session is out of sync (a frame was lost, corrupted, or reordered
    past its successor); nothing can be restored until an I-frame arrives.
    The recovery layer turns this into a NACK on the downlink.
    """


@dataclass(frozen=True)
class SessionFrame:
    """One parsed session frame (header fields + verified payload)."""
    session_id: int
    seq: int
    ref_seq: int                 # seq of the reference frame (I: == seq)
    intra: bool
    level: int                   # index into the session's QoS ladder
    payload: bytes               # a BaF2 container (verified by CRC)

    def pack(self) -> bytes:
        hdr = _HEADER.pack(SESSION_MAGIC, SESSION_WIRE_VERSION,
                           FRAME_I if self.intra else FRAME_P,
                           self.level, 0, self.session_id, self.seq,
                           self.ref_seq, len(self.payload))
        return b"".join([hdr, _CRC.pack(zlib.crc32(hdr)), self.payload,
                         _CRC.pack(zlib.crc32(self.payload))])

    @classmethod
    def parse(cls, blob: bytes) -> "SessionFrame":
        if len(blob) < HEADER_BYTES:
            raise CorruptStream(
                f"truncated session frame header: {len(blob)} bytes, "
                f"need {HEADER_BYTES}")
        (magic, version, frame_type, level, _reserved, session_id, seq,
         ref_seq, payload_len) = _HEADER.unpack_from(blob, 0)
        if magic != SESSION_MAGIC:
            raise CorruptStream(f"bad session frame magic {magic!r}")
        if version != SESSION_WIRE_VERSION:
            raise CorruptStream(
                f"unsupported session wire version {version}")
        (hdr_crc,) = _CRC.unpack_from(blob, _HEADER.size)
        if hdr_crc != zlib.crc32(blob[:_HEADER.size]):
            raise CorruptStream("session frame header CRC mismatch")
        if frame_type not in (FRAME_I, FRAME_P):
            raise CorruptStream(f"unknown session frame type {frame_type}")
        end = HEADER_BYTES + payload_len
        if end + _CRC.size > len(blob):
            raise CorruptStream(
                f"truncated session frame payload: header promises "
                f"{payload_len} bytes, {len(blob) - HEADER_BYTES - _CRC.size}"
                f" available")
        if end + _CRC.size < len(blob):
            raise CorruptStream(
                f"trailing garbage after session frame: "
                f"{len(blob) - end - _CRC.size} bytes")
        payload = blob[HEADER_BYTES:end]
        (payload_crc,) = _CRC.unpack_from(blob, end)
        if payload_crc != zlib.crc32(payload):
            raise CorruptStream("session frame payload CRC mismatch")
        return cls(session_id=session_id, seq=seq, ref_seq=ref_seq,
                   intra=frame_type == FRAME_I, level=level, payload=payload)


@dataclass(frozen=True)
class SessionConfig:
    """Session establishment state both ends agree on before frame 1.

    levels : the QoS ladder, best first — the frame header's ``level`` byte
             indexes this tuple, so encoder and decoder resolve coding
             parameters without per-frame negotiation
    keyframe_interval : force an I-frame every N frames (0 = none; P-frames
             flow until a NACK or level change forces intra refresh).
             Per-level overrides live on the QoS ladder (manager).
    """
    session_id: int
    levels: tuple[OperatingPoint, ...]
    keyframe_interval: int = 0

    def __post_init__(self):
        if not self.levels:
            raise ValueError("session needs at least one operating point")
        if len(self.levels) > 256:
            raise ValueError("level is a u8: at most 256 ladder steps")
        if self.keyframe_interval < 0:
            raise ValueError("keyframe_interval must be >= 0")


@dataclass(frozen=True)
class FrameMeta:
    """Encode-side accounting for one emitted frame."""
    seq: int
    intra: bool
    level: int
    op: OperatingPoint
    wire_bits: int               # full frame: header + payload + CRCs
    payload_bits: int


def _delta_mod(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """``(a - b) mod 2^bits`` of two code tensors on their device, in the
    codes' dtype. The subtraction runs in int32 (CUDA implements few ops
    for uint16, the code dtype from 9 bits up); two's-complement wrap
    followed by the mask IS subtraction mod 2^bits."""
    mask = (1 << bits) - 1
    return ((a.to(torch.int32) - b.to(torch.int32)) & mask).to(a.dtype)


class SessionEncoder:
    """Edge-side session state: holds the previous frame's quantized codes.

    ``plan_for`` maps an operating point to its (cached) CompressionPlan —
    pass the gateway's ``plan_for`` so sessions share plan/jit caches with
    stateless serving. ``capabilities`` is the *decode* side's; when it does
    not speak the session profile (and may downgrade), the encoder emits
    I-frames only.
    """

    def __init__(self, cfg: SessionConfig, plan_for: Callable, *,
                 capabilities: Capabilities | None = None):
        self.cfg = cfg
        self.plan_for = plan_for
        self.temporal = negotiate_session(capabilities)
        self.seq = 0
        self._ref_codes: torch.Tensor | None = None     # on the plan's device
        self._ref_seq = -1
        self._ref_level = -1
        self._last_intra_seq = -1
        self._force_intra = False

    @property
    def force_intra_pending(self) -> bool:
        return self._force_intra

    def nack(self) -> None:
        """A downlink NACK arrived: the next frame must be an I-frame."""
        self._force_intra = True

    def _wants_intra(self, level: int, keyframe_interval: int) -> bool:
        if (not self.temporal or self._ref_codes is None
                or self._force_intra or level != self._ref_level):
            return True
        return (keyframe_interval > 0
                and self.seq - self._last_intra_seq >= keyframe_interval)

    def encode(self, z, *, level: int = 0,
               keyframe_interval: int | None = None
               ) -> tuple[bytes, FrameMeta]:
        """Code one frame's split activation ``z`` (1, H, W, P) -> wire bytes.

        Emits an I-frame when the session state demands one (first frame,
        pending NACK, level change, keyframe cadence, or a decoder that
        never negotiated temporal frames), else a P-frame against the
        previous frame's codes. The reference advances to *this* frame
        either way — P-frames always chain to their immediate predecessor.
        """
        if not 0 <= level < len(self.cfg.levels):
            raise ValueError(f"level {level} outside the session ladder "
                             f"(0..{len(self.cfg.levels) - 1})")
        interval = (self.cfg.keyframe_interval if keyframe_interval is None
                    else keyframe_interval)
        op = self.cfg.levels[level]
        plan = self.plan_for(op)
        codes, mins, maxs = plan._quantize(z)
        raw_bits = int(np.prod(tuple(z.shape))) * 32
        intra = self._wants_intra(level, interval)
        if intra:
            blob = plan.encode_device_codes(codes, mins, maxs,
                                            raw_bits=raw_bits)
            ref_seq = self.seq
            self._last_intra_seq = self.seq
            self._force_intra = False
        else:
            delta = _delta_mod(codes, self._ref_codes, plan.op.bits)
            blob = plan.encode_device_codes(delta, mins, maxs,
                                            raw_bits=raw_bits)
            ref_seq = self._ref_seq
        frame = SessionFrame(session_id=self.cfg.session_id, seq=self.seq,
                             ref_seq=ref_seq, intra=intra, level=level,
                             payload=blob.data).pack()
        meta = FrameMeta(seq=self.seq, intra=intra, level=level, op=plan.op,
                         wire_bits=8 * len(frame),
                         payload_bits=8 * len(blob.data))
        self._ref_codes = codes
        self._ref_seq = self.seq
        self._ref_level = level
        self.seq += 1
        return frame, meta


class SessionDecoder:
    """Cloud-side session state: mirrors the encoder's reference chain.

    ``decode`` either returns exactly the codes the encoder quantized —
    bit-identical whether they traveled as an I-frame or a P-chain — or
    raises. :class:`CorruptStream` = the bytes are damaged (CRC/framing);
    :class:`SessionDesync` = the bytes are fine but reference state this
    decoder does not hold. Neither mutates the reference, so one bad frame
    cannot poison later recovery; both should be answered with a NACK.
    """

    def __init__(self, cfg: SessionConfig, plan_for: Callable):
        self.cfg = cfg
        self.plan_for = plan_for
        self.synced = False
        self._ref_codes: np.ndarray | None = None
        self._ref_seq = -1
        self._ref_level = -1
        self.last_decoded_seq = -1

    def decode(self, blob: bytes) -> tuple[DecodedBatch, SessionFrame]:
        frame = SessionFrame.parse(blob)
        if frame.session_id != self.cfg.session_id:
            raise CorruptStream(
                f"frame for session {frame.session_id} arrived at session "
                f"{self.cfg.session_id}")
        if frame.level >= len(self.cfg.levels):
            raise CorruptStream(
                f"frame level {frame.level} outside the agreed ladder "
                f"({len(self.cfg.levels)} levels)")
        op = self.cfg.levels[frame.level]
        plan = self.plan_for(op)
        try:
            enc = EncodedTensor.from_bytes(frame.payload)
            decoded = plan.decode(blob_from_tensor(enc, plan.op, 1))
        except (ValueError, CorruptStream) as e:
            # the payload CRC passed, so this is a malformed-but-intact
            # container (encoder bug or a forged CRC); surface it as
            # corruption, never as decoded codes
            raise CorruptStream(f"session frame payload rejected: {e}") \
                from e
        if frame.intra:
            codes = decoded.codes
        else:
            if (not self.synced or frame.ref_seq != self._ref_seq
                    or frame.level != self._ref_level):
                raise SessionDesync(
                    f"P-frame {frame.seq} references frame {frame.ref_seq} "
                    f"level {frame.level}; decoder holds "
                    f"{self._ref_seq if self.synced else 'nothing'} level "
                    f"{self._ref_level}")
            ref = self._ref_codes
            mask = np.array((1 << plan.op.bits) - 1, dtype=ref.dtype)
            codes = ((decoded.codes.astype(ref.dtype) + ref) & mask)
        self._ref_codes = codes
        self._ref_seq = frame.seq
        self._ref_level = frame.level
        self.synced = True
        self.last_decoded_seq = frame.seq
        out = DecodedBatch(codes=codes, mins=decoded.mins, maxs=decoded.maxs)
        return out, frame

    def desync(self) -> None:
        """Drop reference state (e.g. the transport reported a lost frame
        before any successor arrived)."""
        self.synced = False
