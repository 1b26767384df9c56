"""Schema'd benchmark records (``BENCH_<name>.json``) and the trajectory
comparison that gates on them.

Copy of ``repro/obs/bench.py`` for the port.

Every benchmark under benchmarks/ writes one record per run:

    {
      "schema": "repro-bench/1",
      "name": "codec",
      "git_sha": "<HEAD or 'unknown'>",
      "config": {...inputs that must match for a comparison to be fair...},
      "metrics": {
        "rans_vs_zlib_8bit": {"value": 0.82, "better": "lower",
                               "tolerance": 0.05},
        ...
      },
      "raw": {...optional, full benchmark output, never compared...}
    }

``benchmarks/compare.py`` loads a current and a baseline record and fails
(exit 1) when any gated metric regressed beyond its tolerance. Rules:

  * the **baseline**'s ``tolerance`` gates; ``tolerance: null`` marks a
    metric informational (wall-clock throughputs on shared CI runners) —
    reported, never failed;
  * ``better`` gives the regression direction: ``lower`` fails when
    ``current > baseline * (1 + tol)``, ``higher`` when
    ``current < baseline * (1 - tol)``; a zero baseline compares
    absolutely against ``tol``;
  * a gated metric missing from the current record fails (a benchmark that
    silently stopped measuring something is itself a regression);
  * differing ``config`` fails unless explicitly allowed — comparing a
    smoke run against a full run is meaningless, not a pass.
"""
from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass

SCHEMA_VERSION = "repro-bench/1"
_BETTER = ("lower", "higher")


def git_sha(cwd: str | None = None) -> str:
    """Best-effort HEAD sha for the bench record's provenance field.

    The canonical allowlisted best-effort site (lint rule RA06, see
    docs/ANALYSIS.md): every failure mode has the same meaning — "no git
    identity available here" — and a committed fallback. Even so, the
    handler names the concrete types it expects (git missing/unrunnable ->
    OSError, nonzero exit/timeout -> SubprocessError) rather than a
    blanket ``except Exception``, so a genuine bug (say, a TypeError from
    a bad ``cwd``) still surfaces loudly.
    """
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (subprocess.SubprocessError, OSError):
        return os.environ.get("GITHUB_SHA", "unknown")


def metric(value: float, *, better: str = "lower",
           tolerance: float | None = None) -> dict:
    """One metric entry. ``tolerance=None`` = informational (never gates)."""
    if better not in _BETTER:
        raise ValueError(f"better must be one of {_BETTER}, got {better!r}")
    if tolerance is not None and tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    return {"value": float(value), "better": better, "tolerance": tolerance}


def bench_record(name: str, *, config: dict, metrics: dict,
                 raw=None) -> dict:
    rec = {"schema": SCHEMA_VERSION, "name": name, "git_sha": git_sha(),
           "config": config, "metrics": metrics}
    if raw is not None:
        rec["raw"] = raw
    validate_record(rec)
    return rec


def validate_record(rec) -> None:
    """Raise ValueError unless ``rec`` is a well-formed bench record."""
    if not isinstance(rec, dict):
        raise ValueError("bench record must be a JSON object")
    if rec.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema {rec.get('schema')!r} "
                         f"(want {SCHEMA_VERSION!r})")
    if not isinstance(rec.get("name"), str) or not rec["name"]:
        raise ValueError("bench record needs a non-empty string 'name'")
    if not isinstance(rec.get("config"), dict):
        raise ValueError("bench record needs a 'config' object")
    metrics = rec.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError("bench record needs a 'metrics' object")
    for key, m in metrics.items():
        if not isinstance(m, dict) or "value" not in m:
            raise ValueError(f"metric {key!r}: needs a 'value'")
        if not isinstance(m["value"], (int, float)):
            raise ValueError(f"metric {key!r}: value must be a number")
        if m.get("better", "lower") not in _BETTER:
            raise ValueError(f"metric {key!r}: better must be in {_BETTER}")
        tol = m.get("tolerance")
        if tol is not None and (not isinstance(tol, (int, float)) or tol < 0):
            raise ValueError(f"metric {key!r}: tolerance must be null or a "
                             f"number >= 0")


def write_bench(path, record: dict) -> None:
    validate_record(record)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


def load_bench(path) -> dict:
    with open(path) as f:
        rec = json.load(f)
    validate_record(rec)
    return rec


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Delta:
    """One line of a comparison report."""
    key: str
    status: str          # ok | improved | regressed | info | missing | new
                         # | name-mismatch | config-drift
    message: str
    base: float | None = None
    cur: float | None = None

    @property
    def failed(self) -> bool:
        return self.status in ("regressed", "missing", "name-mismatch",
                               "config-drift")


def _ratio_txt(base: float, cur: float) -> str:
    if base == 0:
        return f"{base:.6g} -> {cur:.6g}"
    return f"{base:.6g} -> {cur:.6g} ({cur / base:+.1%} rel)".replace(
        "+0.0%", "+0%")


def compare(current: dict, baseline: dict, *,
            allow_config_drift: bool = False) -> tuple[bool, list[Delta]]:
    """Gate ``current`` against ``baseline``; (ok, report deltas)."""
    validate_record(current)
    validate_record(baseline)
    deltas: list[Delta] = []
    if current["name"] != baseline["name"]:
        deltas.append(Delta(
            key="name", status="name-mismatch",
            message=f"comparing {current['name']!r} against "
                    f"{baseline['name']!r}"))
        return False, deltas
    drift = sorted(k for k in set(current["config"]) | set(baseline["config"])
                   if current["config"].get(k) != baseline["config"].get(k))
    for k in drift:
        deltas.append(Delta(
            key=f"config.{k}",
            status="info" if allow_config_drift else "config-drift",
            message=f"config {k!r}: baseline "
                    f"{baseline['config'].get(k)!r} vs current "
                    f"{current['config'].get(k)!r}"))
    for key in sorted(baseline["metrics"]):
        bm = baseline["metrics"][key]
        base = float(bm["value"])
        if key not in current["metrics"]:
            tol = bm.get("tolerance")
            deltas.append(Delta(
                key=key, status="missing" if tol is not None else "info",
                base=base,
                message=f"gated metric disappeared from current record"
                if tol is not None else "informational metric not emitted"))
            continue
        cur = float(current["metrics"][key]["value"])
        better = bm.get("better", "lower")
        tol = bm.get("tolerance")
        txt = _ratio_txt(base, cur)
        if tol is None:
            deltas.append(Delta(key=key, status="info", base=base, cur=cur,
                                message=txt))
            continue
        if base == 0.0:
            bad = cur > tol if better == "lower" else cur < -tol
            good = cur < -tol if better == "lower" else cur > tol
        elif better == "lower":
            bad, good = cur > base * (1 + tol), cur < base * (1 - tol)
        else:
            bad, good = cur < base * (1 - tol), cur > base * (1 + tol)
        status = "regressed" if bad else ("improved" if good else "ok")
        deltas.append(Delta(key=key, status=status, base=base, cur=cur,
                            message=f"{txt} [tol {tol:g}, better {better}]"))
    for key in sorted(set(current["metrics"]) - set(baseline["metrics"])):
        deltas.append(Delta(
            key=key, status="new", cur=float(current["metrics"][key]["value"]),
            message="new metric (no baseline)"))
    ok = not any(d.failed for d in deltas)
    return ok, deltas


def format_report(deltas: list[Delta], *, verbose: bool = True) -> str:
    lines = []
    for d in deltas:
        if not verbose and d.status in ("ok", "info", "new"):
            continue
        lines.append(f"[{d.status.upper():>9}] {d.key}: {d.message}")
    counts: dict[str, int] = {}
    for d in deltas:
        counts[d.status] = counts.get(d.status, 0) + 1
    lines.append("summary: " + ", ".join(
        f"{v} {k}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
