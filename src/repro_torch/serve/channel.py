"""Deterministic, seedable channel models for the collaborative-intelligence
gateway (repro_torch.serve.gateway).

Copy of ``repro/serve/channel.py`` for the port (numpy and stdlib only).

The paper's premise is a bandwidth-constrained uplink between an edge device
and the cloud. This module simulates that link with a virtual clock so the
gateway can be tested and benchmarked deterministically:

  * serialization delay — ``bits / bandwidth_bps``,
  * propagation delay   — ``base_latency_s`` plus optional uniform jitter
                          drawn from a seeded generator,
  * a single-transmission-at-a-time link: a new transmission starts only
    after the previous one has finished serializing,
  * an optional per-tick bit budget: the channel grants at most
    ``budget_bits_per_tick`` bits in any window of ``tick_s`` seconds; a
    transmission that does not fit in the remaining budget waits for the next
    tick (and may span several ticks). The rate controller reads
    ``budget_remaining()`` to pick an operating point that fits.

All times are in seconds on the channel's own virtual clock; nothing here
sleeps or touches the wall clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChannelConfig:
    bandwidth_bps: float = 1e6       # bits per second on the wire
    base_latency_s: float = 0.01     # one-way propagation delay
    jitter_s: float = 0.0            # uniform [0, jitter_s) added per packet
    tick_s: float = 1.0              # budget accounting window
    budget_bits_per_tick: int | None = None   # None = unmetered
    # per-packet impairments (transmit_frame only; the metering paths
    # transmit/transmit_bytes stay lossless). Draws come from the channel's
    # seeded generator, so impaired runs replay bit-identically.
    loss_p: float = 0.0              # P(packet dropped in flight)
    corrupt_p: float = 0.0           # P(one bit flipped in a surviving packet)
    reorder_p: float = 0.0           # P(packet delayed by reorder_delay_s)
    reorder_delay_s: float = 0.0     # extra delay a reordered packet suffers
    mtu_bytes: int | None = None     # packetization unit (None = one packet)

    def __post_init__(self):
        for f in ("loss_p", "corrupt_p", "reorder_p"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be a probability, got {v}")
        if self.reorder_delay_s < 0:
            raise ValueError("reorder_delay_s must be >= 0")
        if self.mtu_bytes is not None and self.mtu_bytes < 1:
            raise ValueError("mtu_bytes must be >= 1")


@dataclass(frozen=True)
class Transmission:
    """One packet's journey through the simulated link."""
    bits: int
    t_submit: float       # when the sender handed the packet to the channel
    t_start: float        # when the wire started serializing it
    t_arrive: float       # when the last bit (+ propagation) reached the cloud

    @property
    def latency_s(self) -> float:
        return self.t_arrive - self.t_submit

    @property
    def queue_wait_s(self) -> float:
        return self.t_start - self.t_submit


@dataclass(frozen=True)
class FrameDelivery:
    """One frame's packetized journey through a (possibly lossy) link.

    ``data`` is what the receiver can reassemble: None when any packet was
    lost (the frame cannot be reconstructed), otherwise the concatenated
    packet bytes — possibly bit-flipped when ``corrupted``. The bits of lost
    packets still occupied the wire (``tx.bits`` counts every packet sent);
    ``tx.t_arrive`` is when reassembly completes, i.e. the *last* packet's
    arrival — a reordered packet delays its whole frame.
    """
    tx: Transmission
    data: bytes | None
    n_packets: int
    lost_packets: int
    corrupted: bool

    @property
    def lost(self) -> bool:
        return self.data is None


class SimulatedChannel:
    """Virtual-clock channel; every run with the same seed is bit-identical."""

    def __init__(self, cfg: ChannelConfig, *, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.now = 0.0                 # virtual clock (advanced by transmits)
        self._busy_until = 0.0         # wire occupied until here
        self._tick_used: dict[int, int] = {}   # tick index -> bits consumed
        self._metrics = None           # obs.MetricsRegistry (bind_metrics)
        self._metric_labels: dict = {}

    def bind_metrics(self, registry, **labels) -> None:
        """Mirror per-transmission accounting into an obs.MetricsRegistry
        (``channel_transmissions_total``, ``channel_wire_bits_total``,
        ``channel_queue_wait_seconds``), labeled e.g. ``tenant=...``.

        Handles are resolved once here — ``transmit`` is on the per-request
        hot path and must not pay a registry lookup per packet."""
        self._metrics = registry
        self._metric_labels = labels
        self._m_tx = registry.counter("channel_transmissions_total", **labels)
        self._m_bits = registry.counter("channel_wire_bits_total", **labels)
        self._m_wait = registry.histogram("channel_queue_wait_seconds",
                                          **labels)

    def reset(self) -> None:
        """Back to t=0 with the original seed — two serve runs over one
        channel replay bit-identically (benchmarks, deterministic tests)."""
        self._rng = np.random.default_rng(self.seed)
        self.now = 0.0
        self._busy_until = 0.0
        self._tick_used.clear()

    # -- budget -------------------------------------------------------------
    def _tick_of(self, t: float) -> int:
        return int(math.floor(t / self.cfg.tick_s))

    def budget_remaining(self, at: float | None = None) -> float:
        """Bits still grantable in the tick containing ``at`` (default: now)."""
        if self.cfg.budget_bits_per_tick is None:
            return math.inf
        tick = self._tick_of(self.now if at is None else at)
        return self.cfg.budget_bits_per_tick - self._tick_used.get(tick, 0)

    def _consume_budget(self, bits: int, t_start: float) -> tuple[float, float]:
        """Spend ``bits`` of tick budget starting at ``t_start``.

        Returns ``(begin, granted_by)``: the (possibly deferred) time the wire
        can begin, and the earliest time the *last* chunk of budget is granted
        — a packet spanning several ticks cannot finish before the tick that
        grants its final bits opens.
        """
        if self.cfg.budget_bits_per_tick is None:
            return t_start, t_start
        per_tick = self.cfg.budget_bits_per_tick
        tick = self._tick_of(t_start)
        # wait for a tick that can grant the packet's first chunk in full
        # (packets larger than a whole tick budget start on a fresh tick)
        first_chunk = min(bits, per_tick)
        while per_tick - self._tick_used.get(tick, 0) < first_chunk:
            tick += 1
        begin = max(t_start, tick * self.cfg.tick_s)
        remaining = bits
        while remaining > 0:
            grant = min(remaining, per_tick - self._tick_used.get(tick, 0))
            self._tick_used[tick] = self._tick_used.get(tick, 0) + grant
            remaining -= grant
            if remaining > 0:
                tick += 1
        return begin, tick * self.cfg.tick_s

    # -- transmission -------------------------------------------------------
    def transmit(self, bits: int, t_submit: float | None = None) -> Transmission:
        """Send ``bits`` over the link; advances the virtual clock."""
        bits = int(bits)
        if bits <= 0:
            raise ValueError(f"cannot transmit {bits} bits")
        t_submit = self.now if t_submit is None else max(t_submit, 0.0)
        t_ready = max(t_submit, self._busy_until)
        t_start, granted_by = self._consume_budget(bits, t_ready)
        serialization = bits / self.cfg.bandwidth_bps
        jitter = (float(self._rng.uniform(0.0, self.cfg.jitter_s))
                  if self.cfg.jitter_s > 0 else 0.0)
        # the last bit leaves no earlier than the tick granting it opens
        t_done = max(t_start + serialization, granted_by)
        t_arrive = t_done + self.cfg.base_latency_s + jitter
        self._busy_until = t_done
        # advance the clock through the whole transmission: the no-arg
        # budget_remaining() must read the tick the wire is committed to,
        # not a tick it already blew past.
        self.now = max(self.now, t_done)
        tx = Transmission(bits=bits, t_submit=t_submit, t_start=t_start,
                          t_arrive=t_arrive)
        if self._metrics is not None:
            self._m_tx.inc()
            self._m_bits.inc(bits)
            self._m_wait.observe(max(0.0, tx.queue_wait_s))
        return tx

    def transmit_bytes(self, data: bytes,
                       t_submit: float | None = None) -> Transmission:
        """Packetize an encoded wire blob: meters the *actual* container
        length (header + side info + entropy-coded payload), so channel
        occupancy reflects real bytes on the wire, not an estimate."""
        if len(data) == 0:
            raise ValueError("cannot transmit an empty packet")
        return self.transmit(8 * len(data), t_submit)

    def transmit_frame(self, data: bytes,
                       t_submit: float | None = None) -> FrameDelivery:
        """Packetize one frame at ``cfg.mtu_bytes`` and send each packet
        through the impaired link (loss / single-bit corruption / reorder
        delay, each an independent seeded draw per packet).

        Serialization and budget accounting go through :meth:`transmit`, so
        frames and plain blobs share one wire model; the frame arrives when
        its last packet does. Impairment-free configs make this exactly
        ``transmit_bytes`` plus packetization.
        """
        if len(data) == 0:
            raise ValueError("cannot transmit an empty frame")
        cfg = self.cfg
        mtu = cfg.mtu_bytes if cfg.mtu_bytes is not None else len(data)
        t_submit = self.now if t_submit is None else max(t_submit, 0.0)
        parts: list[bytes | None] = []
        first_start = None
        last_arrive = 0.0
        lost = 0
        corrupted = False
        for off in range(0, len(data), mtu):
            pkt = data[off:off + mtu]
            ptx = self.transmit(8 * len(pkt), t_submit)
            if first_start is None:
                first_start = ptx.t_start
            arrive = ptx.t_arrive
            # draws are gated on the probabilities so impairment-free frames
            # consume exactly the same RNG stream as transmit_bytes
            if cfg.loss_p > 0 and self._rng.random() < cfg.loss_p:
                lost += 1
                parts.append(None)
            else:
                if cfg.corrupt_p > 0 and self._rng.random() < cfg.corrupt_p:
                    flipped = bytearray(pkt)
                    pos = int(self._rng.integers(0, 8 * len(pkt)))
                    flipped[pos >> 3] ^= 1 << (pos & 7)
                    pkt = bytes(flipped)
                    corrupted = True
                if cfg.reorder_p > 0 and self._rng.random() < cfg.reorder_p:
                    arrive += cfg.reorder_delay_s
                parts.append(pkt)
            last_arrive = max(last_arrive, arrive)
        tx = Transmission(bits=8 * len(data), t_submit=t_submit,
                          t_start=first_start, t_arrive=last_arrive)
        payload = None if lost else b"".join(parts)
        return FrameDelivery(tx=tx, data=payload, n_packets=len(parts),
                             lost_packets=lost, corrupted=corrupted)

    def advance(self, dt: float) -> None:
        """Move the virtual clock forward (new tick budgets become current)."""
        if dt < 0:
            raise ValueError("time moves forward only")
        self.now += dt
