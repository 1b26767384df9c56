"""CLI: ``python -m repro_torch.analysis [--check] [--json FILE] [--fix] ...``

Exit codes: 0 clean (or informational run), 1 failed ``--check``, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _default_root() -> str:
    """The tree this installed package belongs to: src/repro_torch/analysis/ is
    three levels below the repo root, so a scratch copy of the repo analyzed
    with PYTHONPATH=<copy>/src checks the copy, not the original."""
    here = os.path.abspath(os.path.dirname(__file__))
    cand = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return cand


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Invariant linter: determinism, virtual-clock purity, "
                    "build discipline, and wire-format hygiene "
                    "(rules RA01..RA06; see docs/ANALYSIS.md)")
    parser.add_argument("paths", nargs="*",
                        help="specific files to analyze (default: "
                             "src/repro_torch/, tools/, chip_smoke.py and "
                             "the port's tests under --root)")
    parser.add_argument("--root", default=_default_root(),
                        help="repo root (default: the tree this package "
                             "is imported from)")
    parser.add_argument("--check", action="store_true",
                        help="gate against the baseline + wire fingerprints; "
                             "exit 1 on any failure")
    parser.add_argument("--json", metavar="FILE",
                        help="write the machine-readable report ('-' for "
                             "stdout)")
    parser.add_argument("--fix", action="store_true",
                        help="apply the mechanical autofixes (RA02 legacy "
                             "RNG -> default_rng, RA06 bare except -> typed) "
                             "before analyzing")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the ratchet baseline from the current "
                             "unsuppressed violation counts")
    parser.add_argument("--update-wire-schema", action="store_true",
                        help="regenerate the committed wire-format "
                             "fingerprints (only alongside a revision bump)")
    parser.add_argument("--baseline", metavar="FILE",
                        help="baseline path (default: "
                             "src/repro_torch/analysis/baseline.json)")
    parser.add_argument("--wire-schema", metavar="FILE",
                        help="wire schema path (default: "
                             "src/repro_torch/analysis/wire_schema.json)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--quiet", action="store_true",
                        help="only failures and the summary line")
    args = parser.parse_args(argv)

    from repro_torch.analysis import engine, fixes, rules, wire

    if args.list_rules:
        for rule in sorted(rules.RULES.values(), key=lambda r: r.id):
            fix = " [--fix]" if rule.fixable else ""
            print(f"{rule.id}{fix}: {rule.title}")
            print(f"      guards: {rule.guards}")
        print(f"{rules.RA04_ID}: {rules.RA04_TITLE}")
        print("RA00: pragma hygiene (reason mandatory, no unused/unknown "
              "suppressions); never baselineable")
        return 0

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or engine.default_baseline_path(root)
    schema_path = args.wire_schema or engine.default_wire_schema_path(root)

    if args.fix:
        applied = 0
        for rel in engine.discover_files(root, paths=args.paths or None):
            for fix in fixes.fix_file(os.path.join(root, rel)):
                applied += 1
                if not args.quiet:
                    print(f"fixed {rel}:{fix.line} [{fix.rule}] "
                          f"{fix.description}")
        print(f"--fix applied {applied} rewrite(s)")

    if args.update_wire_schema:
        schema = wire.write_wire_schema(root, schema_path)
        for family, entry in sorted(schema["families"].items()):
            print(f"wire schema {family}: revision {entry['revision']} "
                  f"layout {entry['layout_sha256'][:12]}")

    result = engine.run_analysis(root, paths=args.paths or None,
                                 baseline_path=baseline_path,
                                 wire_schema_path=schema_path)

    if args.update_baseline:
        engine.write_baseline(baseline_path, result.counts,
                              rules.config_fingerprint())
        print(f"baseline updated: {sum(result.counts.values())} "
              f"violation(s) across {len(result.counts)} rule:file key(s)")
        result = engine.run_analysis(root, paths=args.paths or None,
                                     baseline_path=baseline_path,
                                     wire_schema_path=schema_path)

    if not args.quiet:
        for v in result.violations:
            if v.suppressed:
                continue
            print(f"{v.path}:{v.line}:{v.col} [{v.rule}] {v.message}")
        suppressed = [v for v in result.violations if v.suppressed]
        for v in suppressed:
            print(f"{v.path}:{v.line}:{v.col} [{v.rule}] suppressed -- "
                  f"{v.reason}")

    if args.json:
        payload = json.dumps(result.to_json(), indent=1, sort_keys=True)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")

    n_unsup = len(result.unsuppressed())
    n_sup = len(result.violations) - n_unsup
    wire_ok = all(e.get("status") in ("ok", "absent")
                  for e in result.wire.values())
    print(f"repro_torch.analysis: {result.files_scanned} files, "
          f"{n_unsup} unsuppressed violation(s), {n_sup} suppressed, "
          f"wire schema {'ok' if wire_ok else 'FAILED'}")

    if args.check:
        for failure in result.failures:
            print(f"CHECK FAILED: {failure}", file=sys.stderr)
        if result.failures:
            return 1
        print("check passed: ratchet, pragmas, and wire fingerprints clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
