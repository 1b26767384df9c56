"""Analysis engine: file discovery, pragmas, the ratchet baseline, reports.

The engine is deliberately boring: parse every ``*.py`` under the roots,
hand each file to every registered rule, attach inline suppressions, fold
in the cross-file RA04 wire check, then gate against the committed baseline.

Suppression pragma grammar (reason mandatory)::

    <code>  # repro_torch: allow[RA01] -- measures real compute wall for the cost fit
    # repro_torch: allow[RA02, RA06] -- fuzz harness: entropy is the point

A pragma suppresses matching violations on its own line or the line below
(for own-line pragmas above a statement). Pragma hygiene is rule RA00 —
missing reason, unknown rule id, or a pragma that suppresses nothing — and
RA00/RA04 violations are *hard*: they fail ``--check`` directly and can
never be ratcheted into the baseline.

Baseline file (``src/repro_torch/analysis/baseline.json``)::

    {"schema": "repro-analysis-baseline/1",
     "config_fingerprint": "<sha256 of rules+config>",
     "violations": {"RA05:src/repro_torch/foo.py": 2, ...}}

``--check`` fails when (a) any ``RULE:path`` count exceeds its baseline
entry beyond ``$MAX_LINT_VIOLATIONS`` (default 0) total excess, (b) any
baseline entry exceeds the current count — a fixed violation must lower
the baseline in the same commit, mirroring the tier-1 ratchet, (c) the
config fingerprint drifted, or (d) any hard (RA00/RA04/parse) violation
exists.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field, replace

BASELINE_SCHEMA = "repro-analysis-baseline/1"
REPORT_SCHEMA = "repro-analysis/1"
DEFAULT_ROOTS = ("src/repro_torch", "tools")
# the port's files outside those roots (the reference's tests and modules
# carry the reference's own pragmas, which this linter does not read)
DEFAULT_FILES = ("chip_smoke.py", "tests/torch_ranks.py")
DEFAULT_PREFIXES = ("tests/test_torch_",)
HARD_RULES = ("RA00", "RA04", "PARSE")

_PRAGMA_RE = re.compile(
    r"#\s*repro_torch:\s*allow\[([^\]]*)\]\s*(?:--\s*(\S.*\S|\S))?\s*$")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str                    # repo-relative, posix separators
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str | None = None

    def key(self) -> str:
        return f"{self.rule}:{self.path}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed, "reason": self.reason}


@dataclass(frozen=True)
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: str | None


@dataclass
class FileContext:
    """One parsed file as the rules see it."""
    path: str                    # repo-relative
    source: str
    tree: ast.AST
    alias: dict[str, str]
    pragmas: dict[int, Pragma] = field(default_factory=dict)


@dataclass
class AnalysisResult:
    root: str
    violations: list[Violation]          # every finding, suppressed included
    counts: dict[str, int]               # unsuppressed, baselineable, by key
    failures: list[str]                  # why --check fails (empty = ok)
    wire: dict                           # per-family fingerprint summary
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures

    def unsuppressed(self) -> list[Violation]:
        return [v for v in self.violations if not v.suppressed]

    def to_json(self) -> dict:
        by_rule: dict[str, int] = {}
        for v in self.unsuppressed():
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        return {"schema": REPORT_SCHEMA, "root": self.root,
                "files_scanned": self.files_scanned,
                "ok": self.ok, "failures": self.failures,
                "violations": [v.to_json() for v in self.violations],
                "counts_by_rule": dict(sorted(by_rule.items())),
                "counts_by_key": dict(sorted(self.counts.items())),
                "wire": self.wire}


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

def parse_pragmas(source: str, path: str) -> tuple[dict[int, Pragma],
                                                   list[Violation]]:
    """Comment pragmas via tokenize (never matches inside string literals)."""
    pragmas: dict[int, Pragma] = {}
    bad: list[Violation] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        comments = [(i + 1, line[line.index("#"):])
                    for i, line in enumerate(source.splitlines())
                    if "#" in line]
    for lineno, text in comments:
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2)
        if not rules:
            bad.append(Violation(
                rule="RA00", path=path, line=lineno, col=0,
                message="suppression pragma names no rule ids"))
            continue
        if not reason:
            bad.append(Violation(
                rule="RA00", path=path, line=lineno, col=0,
                message=f"suppression pragma for {', '.join(rules)} has no "
                        f"reason; write '# repro_torch: allow[ID] -- why'"))
            continue
        pragmas[lineno] = Pragma(line=lineno, rules=rules, reason=reason)
    return pragmas, bad


def _apply_pragmas(ctx: FileContext, violations: list[Violation],
                   known_rules: set[str]) -> tuple[list[Violation],
                                                   list[Violation]]:
    """Mark suppressed violations; return (violations, RA00 hygiene extras).

    A pragma applies to its own line, or — when written as an own-line
    comment (possibly with further ``#`` continuation lines under it) — to
    the first statement below the comment block.
    """
    lines = ctx.source.splitlines()

    def pragma_for(line: int) -> Pragma | None:
        if line in ctx.pragmas:
            return ctx.pragmas[line]
        l = line - 1
        while 1 <= l <= len(lines) and lines[l - 1].lstrip().startswith("#"):
            if l in ctx.pragmas:
                return ctx.pragmas[l]
            l -= 1
        return None

    used: set[int] = set()
    out: list[Violation] = []
    for v in violations:
        pragma = pragma_for(v.line)
        if pragma and v.rule in pragma.rules:
            used.add(pragma.line)
            out.append(replace(v, suppressed=True, reason=pragma.reason))
        else:
            out.append(v)
    extras: list[Violation] = []
    for lineno, pragma in sorted(ctx.pragmas.items()):
        unknown = [r for r in pragma.rules if r not in known_rules]
        if unknown:
            extras.append(Violation(
                rule="RA00", path=ctx.path, line=lineno, col=0,
                message=f"pragma names unknown rule id(s) "
                        f"{', '.join(unknown)}"))
        elif lineno not in used:
            extras.append(Violation(
                rule="RA00", path=ctx.path, line=lineno, col=0,
                message=f"unused suppression for "
                        f"{', '.join(pragma.rules)}: nothing on this or the "
                        f"next line violates it — delete the pragma"))
    return out, extras


# ---------------------------------------------------------------------------
# Discovery + per-file pass
# ---------------------------------------------------------------------------

def discover_files(root: str, roots: tuple[str, ...] = DEFAULT_ROOTS,
                   paths: list[str] | None = None) -> list[str]:
    """Repo-relative posix paths of every ``*.py`` under the roots."""
    if paths:
        rels = []
        for p in paths:
            ap = os.path.abspath(p)
            rels.append(os.path.relpath(ap, root).replace(os.sep, "/"))
        return sorted(rels)
    found: list[str] = []
    for sub in roots:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    found.append(rel.replace(os.sep, "/"))
    if roots is DEFAULT_ROOTS:
        found += [f for f in DEFAULT_FILES
                  if os.path.isfile(os.path.join(root, f))]
        for prefix in DEFAULT_PREFIXES:
            base, stem = os.path.split(prefix)
            folder = os.path.join(root, base)
            if os.path.isdir(folder):
                found += [f"{base}/{fn}" for fn in os.listdir(folder)
                          if fn.startswith(stem) and fn.endswith(".py")]
    return sorted(found)


def analyze_file(root: str, rel: str) -> tuple[FileContext | None,
                                               list[Violation]]:
    from repro_torch.analysis import rules as _rules
    abspath = os.path.join(root, rel)
    try:
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return None, [Violation(rule="PARSE", path=rel, line=1, col=0,
                                message=f"unreadable: {e}")]
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return None, [Violation(rule="PARSE", path=rel,
                                line=e.lineno or 1, col=e.offset or 0,
                                message=f"syntax error: {e.msg}")]
    pragmas, bad = parse_pragmas(source, rel)
    ctx = FileContext(path=rel, source=source, tree=tree,
                      alias=_rules.build_alias_map(tree), pragmas=pragmas)
    violations: list[Violation] = list(bad)
    for rule in _rules.RULES.values():
        violations.extend(rule.check(ctx))
    applied, extras = _apply_pragmas(
        ctx, [v for v in violations if v.rule != "RA00"],
        set(_rules.RULES) | {"RA04"})
    return ctx, ([v for v in violations if v.rule == "RA00"]
                 + extras + applied)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def default_baseline_path(root: str) -> str:
    return os.path.join(root, "src", "repro_torch", "analysis",
                        "baseline.json")


def default_wire_schema_path(root: str) -> str:
    return os.path.join(root, "src", "repro_torch", "analysis",
                        "wire_schema.json")


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"unsupported baseline schema "
                         f"{data.get('schema')!r} (want {BASELINE_SCHEMA!r})")
    return data


def write_baseline(path: str, counts: dict[str, int],
                   fingerprint: str) -> None:
    data = {"schema": BASELINE_SCHEMA, "config_fingerprint": fingerprint,
            "violations": dict(sorted(
                (k, v) for k, v in counts.items() if v))}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# The full pass
# ---------------------------------------------------------------------------

def run_analysis(root: str, *, paths: list[str] | None = None,
                 baseline_path: str | None = None,
                 wire_schema_path: str | None = None,
                 max_violations: int | None = None) -> AnalysisResult:
    """Run every rule + the wire check and gate against the baseline.

    ``max_violations`` defaults to ``$MAX_LINT_VIOLATIONS`` (default 0): the
    total count of unsuppressed violations in excess of their baseline
    entries that the run tolerates — the direct analogue of the tier-1
    ``MAX_TIER1_FAILURES`` budget, and like it, meant to stay at 0.
    """
    from repro_torch.analysis import rules as _rules
    from repro_torch.analysis import wire as _wire

    root = os.path.abspath(root)
    if max_violations is None:
        max_violations = int(os.environ.get("MAX_LINT_VIOLATIONS", "0"))
    baseline_path = baseline_path or default_baseline_path(root)
    wire_schema_path = wire_schema_path or default_wire_schema_path(root)

    files = discover_files(root, paths=paths)
    violations: list[Violation] = []
    for rel in files:
        _, file_violations = analyze_file(root, rel)
        violations.extend(file_violations)

    wire_violations, wire_summary = _wire.check_wire_schema(
        root, wire_schema_path)
    violations.extend(wire_violations)

    counts: dict[str, int] = {}
    for v in violations:
        if not v.suppressed and v.rule not in HARD_RULES:
            counts[v.key()] = counts.get(v.key(), 0) + 1

    failures: list[str] = []
    hard = [v for v in violations if not v.suppressed and v.rule in HARD_RULES]
    for v in hard:
        failures.append(f"{v.path}:{v.line} [{v.rule}] {v.message}")

    try:
        baseline = load_baseline(baseline_path)
    except FileNotFoundError:
        baseline = None
        failures.append(
            f"no baseline at {os.path.relpath(baseline_path, root)}; run "
            f"'python -m repro_torch.analysis --update-baseline' and commit it")
    except ValueError as e:
        baseline = None
        failures.append(f"bad baseline: {e}")

    if baseline is not None:
        fp = _rules.config_fingerprint()
        if baseline.get("config_fingerprint") != fp:
            failures.append(
                "config drift: the rule set or its scopes/allowlists "
                "changed but the baseline was not regenerated; rerun "
                "'python -m repro_torch.analysis --update-baseline' so the "
                "change is reviewed, not silent")
        base_counts = {k: int(v) for k, v in
                       baseline.get("violations", {}).items()}
        excess = 0
        for key in sorted(set(counts) | set(base_counts)):
            cur, base = counts.get(key, 0), base_counts.get(key, 0)
            if cur > base:
                excess += cur - base
                failures.append(
                    f"ratchet regression: {key} has {cur} unsuppressed "
                    f"violation(s), baseline allows {base}")
            elif cur < base:
                failures.append(
                    f"stale baseline: {key} improved to {cur} (baseline "
                    f"{base}) — lower the baseline in this commit "
                    f"(--update-baseline); the ratchet only ever tightens")
        if excess and excess <= max_violations:
            # inside the explicit budget: drop only the regression lines
            failures = [f for f in failures
                        if not f.startswith("ratchet regression:")]

    return AnalysisResult(root=root, violations=violations, counts=counts,
                          failures=failures, wire=wire_summary,
                          files_scanned=len(files))
