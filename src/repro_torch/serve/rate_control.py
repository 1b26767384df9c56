"""Adaptive rate control for split inference — pick ``(C, bits)`` per request.

Counterpart of ``repro/serve/rate_control.py``: the same tables, policies and
cache format; ``build_rd_table`` sweeps on the card (``device=None``) through
the port's compression plans, and ``codec_revision`` names the same wire
format, so the RD caches the JAX package wrote hit here too.

The paper sweeps C (transmitted channels) and n (quantizer bits) offline and
reports the accuracy/bits trade-off; deployment needs the inverse mapping:
given the channel's current bit budget and a quality floor, which operating
point do we run *this* request at?  Following the bit-allocation line of work
(Alvar & Bajić 2020; Choi & Bajić 2018) we build an offline rate–distortion
table by sweeping the existing fidelity metrics, then do a table lookup per
request:

  * ``cheapest_meeting_floor`` — the paper-style planner: minimum wire bits
    subject to PSNR >= floor (no channel in the loop),
  * ``select(bit_budget)``     — the channel-adaptive policy: among points
    that fit the budget, prefer those meeting the quality floor and take the
    **highest-PSNR** one (spend the rate the channel grants); if none meeting
    the floor fit, degrade to the best PSNR that fits; if nothing fits,
    send the globally cheapest point rather than dropping the request.

The table is plain data, so tests pin behaviour on a hand-written table and
production builds one with :func:`build_rd_table`.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

from repro_torch import pipeline
from repro_torch.codec.container import VERSION as RANS_VERSION
from repro_torch.core.codec import MAGIC as WIRE_MAGIC
from repro_torch.core.split import (activation_stats, check_device, cnn_fns,
                                    fidelity_metrics, to_device)
from repro_torch.device import resolve_device
# OperatingPoint is owned by the pipeline package; re-exported here so
# serve-side callers import it from repro_torch.serve.
from repro_torch.pipeline import WIRE_PROFILE_VERSION, OperatingPoint


@dataclass(frozen=True)
class RDPoint:
    op: OperatingPoint
    bits_per_example: float    # measured wire cost: true encoded container
                               # bytes * 8 (header + side info + payload),
                               # the same quantity the channel meters
    psnr_db: float             # restoration quality (higher is better)
    kl: float = math.nan       # KL(cloud || split) of downstream logits
    # calibration-time content statistics of the selected C channels —
    # anchor for the per-request PSNR shift (ContentKeyedController); NaN
    # means "no content keying for this point"
    calib_peak: float = math.nan
    calib_range: float = math.nan
    # expected P-frame/I-frame wire-bit ratio of the session codec at this
    # point (repro.session temporal delta coding); NaN means unmeasured —
    # session pricing then falls back to I-only cost, the legacy behaviour
    p_over_i: float = math.nan


class RateController:
    """Table-driven operating-point selection with a PSNR quality floor."""

    def __init__(self, table: list[RDPoint], *, quality_floor_db: float):
        if not table:
            raise ValueError("empty rate-distortion table")
        self.table = sorted(table, key=lambda p: (p.bits_per_example,
                                                  -p.psnr_db))
        self.quality_floor_db = quality_floor_db

    # -- offline planner ----------------------------------------------------
    def cheapest_meeting_floor(self) -> RDPoint:
        """Minimum-rate point with PSNR >= floor (paper-style operating point).

        Falls back to the highest-PSNR point when nothing meets the floor.
        """
        for p in self.table:                      # sorted by cost
            if p.psnr_db >= self.quality_floor_db:
                return p
        return max(self.table, key=lambda p: p.psnr_db)

    # -- per-request, channel-adaptive policy -------------------------------
    def select(self, bit_budget: float | None = None) -> RDPoint:
        """Pick the operating point for one request given the channel budget.

        ``bit_budget=None`` (or inf) means unmetered: equivalent to the full
        table. See module docstring for the 3-tier policy.
        """
        budget = math.inf if bit_budget is None else bit_budget
        fitting = [p for p in self.table if p.bits_per_example <= budget]
        if not fitting:
            return self.table[0]                  # cheapest overall
        meeting = [p for p in fitting if p.psnr_db >= self.quality_floor_db]
        pool = meeting if meeting else fitting
        # highest quality the budget allows; break PSNR ties toward fewer bits
        return max(pool, key=lambda p: (p.psnr_db, -p.bits_per_example))


class ContentKeyedController(RateController):
    """Per-request (C, bits) selection keyed on the request's own content.

    The calibration table's PSNRs are averages over the calibration batch;
    actual requests vary. Quantization noise power scales with the squared
    quantizer step, the step scales with the content's dynamic range, and
    the PSNR peak follows the content's peak — so with the per-C activation
    statistics of *this* request (core.split.activation_stats, O(HWC)) every
    table entry's PSNR shifts by

        20·log10(peak_req / peak_cal) + 20·log10(range_cal / range_req)

    interpolated from the entry's own calibration anchor. Selection then
    runs the same 3-tier budget/floor policy as the base class, but against
    the shifted per-request estimates (Choi & Bajić 2018's per-content
    operating points, as a table shift instead of an online sweep).
    """

    def estimate_psnr_db(self, p: RDPoint, stats=None) -> float:
        """Per-request PSNR estimate for one table entry.

        stats: ActivationStats for p's C (or a dict {c: ActivationStats}).
        Falls back to the calibration PSNR when anchors or stats are absent.
        """
        if isinstance(stats, dict):
            stats = stats.get(p.op.c)
        if stats is None or not (math.isfinite(p.calib_peak)
                                 and math.isfinite(p.calib_range)):
            return p.psnr_db
        eps = 1e-12
        shift = (20.0 * math.log10(max(stats.peak, eps)
                                   / max(p.calib_peak, eps))
                 + 20.0 * math.log10(max(p.calib_range, eps)
                                     / max(stats.dyn_range, eps)))
        return p.psnr_db + shift

    def select_for(self, bit_budget: float | None = None, stats=None,
                   floor_db: float | None = None) -> RDPoint:
        """3-tier policy over per-request PSNR estimates.

        stats    : per-request content statistics ({c: ActivationStats} or a
                   single ActivationStats applied to every C); None degrades
                   to the calibration-table policy
        floor_db : per-tenant floor override (None = controller default)
        """
        floor = self.quality_floor_db if floor_db is None else floor_db
        budget = math.inf if bit_budget is None else bit_budget
        est = {id(p): self.estimate_psnr_db(p, stats) for p in self.table}
        fitting = [p for p in self.table if p.bits_per_example <= budget]
        if not fitting:
            return self.table[0]
        meeting = [p for p in fitting if est[id(p)] >= floor]
        pool = meeting if meeting else fitting
        return max(pool, key=lambda p: (est[id(p)], -p.bits_per_example))


def session_bits_per_frame(point: RDPoint, *, keyframe_interval: int,
                           frame_stride: int = 1) -> float:
    """Expected wire bits per camera frame of a temporal session at this
    operating point.

    RD tables price I-frames (``bits_per_example`` is a standalone
    container); a streaming session interleaves cheap P-frames
    (repro_torch.session), so pricing rungs off the I-only number
    overestimates their wire cost. With the point's measured ``p_over_i`` ratio:

        keyframe_interval k >= 1 : (1 + (k-1)·ratio) / k   of I-frame bits
        keyframe_interval 0      : ratio (steady state all-P after frame 0)

    divided by ``frame_stride`` (a rung serving every Nth camera frame
    offers 1/N of the per-frame load). A NaN ratio degrades to the legacy
    I-only price, so tables without the measurement keep old behaviour.
    """
    if keyframe_interval < 0:
        raise ValueError("keyframe_interval must be >= 0")
    if frame_stride < 1:
        raise ValueError("frame_stride must be >= 1")
    i_bits = point.bits_per_example
    ratio = point.p_over_i
    if not math.isfinite(ratio):
        per_frame = i_bits
    elif keyframe_interval == 0:
        per_frame = ratio * i_bits
    else:
        k = keyframe_interval
        per_frame = i_bits * (1.0 + (k - 1) * ratio) / k
    return per_frame / frame_stride


def rd_grid(baf_bank: dict, bits_sweep=(2, 4, 6, 8),
            backend: str = "zlib") -> list[OperatingPoint]:
    """The default calibration grid: every bank C crossed with the bit sweep
    on one backend. This list is also the RD cache's identity — see
    :func:`load_or_build_rd_table`."""
    return [OperatingPoint(c=c, bits=bits, backend=backend)
            for c in sorted(baf_bank) for bits in bits_sweep]


def build_rd_table(params, baf_bank: dict, imgs, *,
                   bits_sweep=(2, 4, 6, 8), backend: str = "zlib",
                   consolidation: bool = True,
                   ops: "list[OperatingPoint] | None" = None,
                   device=None) -> list[RDPoint]:
    """Offline operating-point sweep with the repo's own fidelity metrics.

    params   : the CNN (models/cnn.py), on ``device``
    baf_bank : {c: (BaFConv, sel_idx)} — one trained BaF predictor per C
               (the BaF net's input width is C, so each C needs its own)
    imgs     : (B, H, W, 3) calibration batch (numpy), moved to ``device``
               once; the costs/metrics are measured on it
    ops      : explicit grid of operating points; default
               ``rd_grid(baf_bank, bits_sweep, backend)``
    device   : where the sweep runs (``None`` = the card)

    Each point's wire cost is measured by compiling its
    :class:`repro_torch.pipeline.CompressionPlan` and encoding every
    calibration example through it — the same code path deployment runs
    (the quantize and histogram kernels on the card).
    """
    dev = resolve_device(device)
    check_device(dev, params=params,
                 **{f"baf_c{c}": p for c, (p, _) in baf_bank.items()})
    if ops is None:
        ops = rd_grid(baf_bank, bits_sweep, backend)
    edge, _ = cnn_fns(params)
    z = edge(to_device(imgs, dev))
    z_host = z.cpu().numpy()
    specs, anchors = {}, {}
    for c, (baf_params, sel_idx) in sorted(baf_bank.items()):
        specs[c] = pipeline.ModelSpec(sel_idx=np.asarray(sel_idx),
                                      params=params, baf_params=baf_params)
        # per-example anchors, averaged: deployment sees single requests
        per_ex = [activation_stats(z_host[i:i + 1], sel_idx)
                  for i in range(imgs.shape[0])]
        anchors[c] = (float(np.mean([s.peak for s in per_ex])),
                      float(np.mean([s.dyn_range for s in per_ex])))
    table = []
    for op in ops:
        if op.c not in baf_bank:
            raise ValueError(f"operating point wants C={op.c} but the bank "
                             f"holds {sorted(baf_bank)}")
        plan = pipeline.compile(op, specs[op.c], consolidation=consolidation,
                                device=dev)
        baf_params, sel_idx = baf_bank[op.c]
        # cost at deployment granularity: the gateway transmits one image
        # per request, and a shared stream over the whole batch would
        # understate that — encode each example alone and average the
        # *actual* container lengths (not a bits*count estimate)
        per_req_bits = [plan.encode(z[i:i + 1]).stats.wire_bits
                        for i in range(imgs.shape[0])]
        psnr, kl = fidelity_metrics(params, baf_params, sel_idx, imgs,
                                    bits=op.bits, consolidation=consolidation,
                                    z=z, device=dev)
        calib_peak, calib_range = anchors[op.c]
        table.append(RDPoint(
            op=op, bits_per_example=float(np.mean(per_req_bits)),
            psnr_db=float(psnr), kl=float(kl),
            calib_peak=calib_peak, calib_range=calib_range))
    return table


# ---------------------------------------------------------------------------
# RD-table disk cache (benchmark / CI time budget)
# ---------------------------------------------------------------------------

def op_to_json(op: OperatingPoint) -> dict:
    return {"c": op.c, "bits": op.bits, "backend": op.backend,
            "tiling": op.tiling, "context": op.context,
            "profile": op.profile}


def op_from_json(r: dict) -> OperatingPoint:
    return OperatingPoint(c=int(r["c"]), bits=int(r["bits"]),
                          backend=str(r.get("backend", "zlib")),
                          tiling=str(r.get("tiling", "auto")),
                          context=str(r.get("context", "auto")),
                          profile=int(r.get("profile",
                                            WIRE_PROFILE_VERSION)))


def rd_table_to_json(table: list[RDPoint]) -> list[dict]:
    return [{**op_to_json(p.op),
             "bits_per_example": p.bits_per_example, "psnr_db": p.psnr_db,
             "kl": p.kl, "calib_peak": p.calib_peak,
             "calib_range": p.calib_range, "p_over_i": p.p_over_i}
            for p in table]


def rd_table_from_json(rows: list[dict]) -> list[RDPoint]:
    return [RDPoint(op=op_from_json(r),
                    bits_per_example=float(r["bits_per_example"]),
                    psnr_db=float(r["psnr_db"]), kl=float(r["kl"]),
                    calib_peak=float(r.get("calib_peak", math.nan)),
                    calib_range=float(r.get("calib_range", math.nan)),
                    p_over_i=float(r.get("p_over_i", math.nan)))
            for r in rows]


def codec_revision() -> str:
    """Identity of the wire format the repo currently emits: container magic,
    rANS container version, and the pipeline wire profile. Any coder change
    that moves container bytes bumps one of these, so RD caches keyed on it
    can never serve stale costs. The JAX package's string for the same wire
    format, so either package's caches serve the other."""
    return (f"{WIRE_MAGIC.decode('ascii')}/rtc{RANS_VERSION}"
            f"/wp{WIRE_PROFILE_VERSION}")


def load_or_build_rd_table(cache_path, key: dict | None = None, build=None, *,
                           ops: "list[OperatingPoint] | None" = None,
                           tasks: dict | None = None) -> list[RDPoint]:
    """RD sweeps re-encode every calibration example at every operating
    point — too slow to redo per CI run now that the rANS backends are in
    the sweep. Cache the table to disk keyed by the sweep's identity.

    The effective cache key is ``key`` (caller-provided sweep inputs such as
    the calibration seed/shape) augmented with:

      * the full ``ops`` grid (every field of every operating point) when
        given — a sweep over different backends, bit depths, tilings, or
        wire profiles can never alias a cached table,
      * :func:`codec_revision` — container-format changes invalidate every
        cached table automatically (pre-plan caches keyed on backend+seed
        only are treated as stale and rebuilt in place), and
      * the ``tasks`` identity when given (head-set + task-weight vector,
        conventionally ``repro.tasks.task_set_key``) — a table swept
        for one task mix can never be served to a caller pricing a
        different head set or weighting; in particular a plain single-task
        cache (no ``tasks`` key on disk) is stale for any task-aware
        caller and rebuilds in place, and vice versa.

    cache_path : JSON file; a miss (re)writes it. The committed
                 ``benchmarks/rd_cache_*.json`` are the JAX benchmarks'
                 caches: read a copy of one, never the file itself
    key        : JSON-serializable dict of extra sweep inputs (seed, calib …)
    build      : zero-arg callable returning the table on cache miss
    ops        : the operating-point grid the build sweeps
    tasks      : JSON-serializable head-set/weight identity of the sweep
    """
    if build is None:
        raise TypeError("load_or_build_rd_table needs a build callable "
                        "(the keyword-style signature makes it optional "
                        "syntactically, never semantically)")
    full_key = dict(key or {})
    if ops is not None:
        full_key["ops"] = [op_to_json(p) for p in ops]
    full_key["codec_rev"] = codec_revision()
    if tasks is not None:
        full_key["tasks"] = dict(tasks)

    cache_path = os.fspath(cache_path)
    try:
        with open(cache_path) as f:
            data = json.load(f)
        if data.get("key") == full_key:
            return rd_table_from_json(data["points"])
    except (OSError, ValueError, KeyError, AttributeError, TypeError):
        pass                         # any unusable cache file -> rebuild
    table = build()
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": full_key, "points": rd_table_to_json(table)}, f,
                  indent=1)
    os.replace(tmp, cache_path)
    return table
