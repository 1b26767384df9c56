"""The port's invariant linter (repro_torch.analysis), against the
reference's own cases of ``tests/test_analysis.py`` on toy trees with the
port's paths: rule fixtures, pragma grammar, the
ratchet baseline, wire-format fingerprints, the autofixer, and the runtime
replay sanitizer.

Rule tests write toy snippets to a tmp tree at *scoped* relative paths
(e.g. ``src/repro_torch/serve/x.py``) because most rules are path-scoped; each
true-positive fixture is paired with a clean twin proving the rule does not
overfire. The RA04 and negative-control tests copy the *real* modules into
a tmp tree and mutate them — the linter must catch exactly the edit the
acceptance criteria describe (a struct layout change without a
``codec_revision()`` bump; a seeded ``time.time()`` in the gateway).
"""
import json
import os
import random
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import (ReplaySanitizerError, engine, fixes,
                            replay_sanitizer, rules, wire)

REPO = Path(__file__).resolve().parents[1]


def _tree(tmp_path, files):
    root = tmp_path / "repo"
    for rel, code in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    return str(root)


def _violations(tmp_path, rel, code, rule=None):
    root = _tree(tmp_path, {rel: code})
    _, vs = engine.analyze_file(root, rel)
    if rule is not None:
        vs = [v for v in vs if v.rule == rule]
    return vs


# ---------------------------------------------------------------------------
# RA01 — virtual-clock purity
# ---------------------------------------------------------------------------

def test_ra01_flags_wall_clock_in_scope(tmp_path):
    code = """\
        import time

        def now():
            return time.time()
    """
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code, "RA01")
    assert len(vs) == 1 and "time.time" in vs[0].message
    assert not vs[0].suppressed


def test_ra01_resolves_from_imports_and_datetime(tmp_path):
    code = """\
        from time import perf_counter
        from datetime import datetime

        def stamp():
            return perf_counter(), datetime.now()
    """
    vs = _violations(tmp_path, "src/repro_torch/session/x.py", code, "RA01")
    assert {m for v in vs for m in [v.message.split("(")[0]]} \
        == {"wall-clock call time.perf_counter",
            "wall-clock call datetime.datetime.now"}


def test_ra01_out_of_scope_and_allowlisted_files_are_clean(tmp_path):
    code = "import time\nT = time.time()\n"
    assert not _violations(tmp_path, "src/repro_torch/kernels/x.py", code, "RA01")
    assert not _violations(tmp_path, "src/repro_torch/obs/hooks.py", code, "RA01")


# ---------------------------------------------------------------------------
# RA02 — determinism: legacy RNG + set iteration
# ---------------------------------------------------------------------------

def test_ra02_flags_legacy_rng_everywhere(tmp_path):
    code = """\
        import random
        import numpy as np

        x = np.random.rand(3)
        random.shuffle([1, 2])
    """
    vs = _violations(tmp_path, "src/repro_torch/models/x.py", code, "RA02")
    assert len(vs) == 2
    assert any("numpy.random.rand" in v.message for v in vs)
    assert any("random.shuffle" in v.message for v in vs)


def test_ra02_explicit_generators_are_clean(tmp_path):
    code = """\
        import random
        import numpy as np

        rng = np.random.default_rng(0)
        x = rng.random(3)
        r = random.Random(0)
        r.shuffle([1, 2])
    """
    assert not _violations(tmp_path, "src/repro_torch/models/x.py", code, "RA02")


def test_ra02_set_iteration_in_scope(tmp_path):
    bad = "for k in {1, 2}:\n    print(k)\n"
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", bad, "RA02")
    assert len(vs) == 1 and "iteration over a set" in vs[0].message
    # sorted() is the fix, not a violation — and out-of-scope trees may
    # iterate sets freely
    good = "for k in sorted({1, 2}):\n    print(k)\n"
    assert not _violations(tmp_path, "src/repro_torch/serve/y.py", good, "RA02")
    assert not _violations(tmp_path, "tools/x.py", bad, "RA02")


def test_ra02_sorted_genexp_over_set_union_is_clean(tmp_path):
    # the obs/bench.py config-drift idiom: a generator over a set union fed
    # straight into sorted() is order-insensitive by construction
    code = """\
        def drift(a, b):
            return sorted(k for k in set(a) | set(b)
                          if a.get(k) != b.get(k))
    """
    assert not _violations(tmp_path, "src/repro_torch/obs/x.py", code, "RA02")


def test_ra02_list_of_set_flagged(tmp_path):
    code = "ORDER = list({'a', 'b'})\n"
    vs = _violations(tmp_path, "src/repro_torch/codec/x.py", code, "RA02")
    assert len(vs) == 1


# ---------------------------------------------------------------------------
# RA03 — build discipline (the port's RA03)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code,what", [
    ("import ctypes\nlib = ctypes.CDLL('x.so')\n", "ctypes.CDLL"),
    ("from ctypes import CDLL\nlib = CDLL('x.so')\n", "ctypes.CDLL"),
    ("import torch\ntorch.ops.load_library('x.so')\n",
     "torch.ops.load_library"),
])
def test_ra03_native_load_flagged_outside_build(tmp_path, code, what):
    vs = _violations(tmp_path, "src/repro_torch/kernels/foo.py", code, "RA03")
    assert len(vs) == 1 and what in vs[0].message
    # the build module is the sanctioned home for exactly this call
    assert not _violations(tmp_path, "src/repro_torch/kernels/_build.py",
                           code, "RA03")


def test_ra03_cpp_extension_imports_flagged(tmp_path):
    code = """\
        import torch.utils.cpp_extension
        from torch.utils import cpp_extension
        from torch.utils.cpp_extension import load_inline
    """
    vs = _violations(tmp_path, "src/repro_torch/serve/foo.py", code, "RA03")
    assert len(vs) == 3 and all("_build.py" in v.message for v in vs)


def test_ra03_build_routed_and_out_of_scope_are_clean(tmp_path):
    code = """\
        from repro_torch.kernels import _build

        _build.FLASH_ATTENTION.launch("f", 0)
    """
    assert not _violations(tmp_path, "src/repro_torch/kernels/foo.py",
                           code, "RA03")
    load = "import ctypes\nlib = ctypes.CDLL('x.so')\n"
    assert not _violations(tmp_path, "tools/probe.py", load, "RA03")


# ---------------------------------------------------------------------------
# RA05 — host-sync inside captured or compiled regions (the port's RA05)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.tolist()",
                                  "x.numpy()", "np.asarray(x)"])
def test_ra05_host_sync_in_compiled_body(tmp_path, call):
    code = f"""\
        import numpy as np
        import torch

        @torch.compile
        def f(x):
            return {call}

        def g(x):
            return {call}

        h = torch.compile(g)
    """
    vs = _violations(tmp_path, "src/repro_torch/core/x.py", code, "RA05")
    assert len(vs) == 2 and all("compiled body" in v.message for v in vs)
    # the same body uncompiled is host code and fine
    clean = f"import numpy as np\n\ndef f(x):\n    return {call}\n"
    assert not _violations(tmp_path, "src/repro_torch/core/y.py", clean,
                           "RA05")


def test_ra05_cuda_graph_capture_body(tmp_path):
    code = """\
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                n = y.sum().item()
            return y, x.item()
    """
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code, "RA05")
    assert len(vs) == 1 and "captured CUDA graph" in vs[0].message
    assert vs[0].line == 6


# ---------------------------------------------------------------------------
# RA06 — silent failure
# ---------------------------------------------------------------------------

def test_ra06_bare_and_silent_catchalls(tmp_path):
    code = """\
        try:
            a()
        except:
            handle()
        try:
            b()
        except Exception:
            pass
    """
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code, "RA06")
    assert len(vs) == 2
    assert any("bare 'except:'" in v.message for v in vs)
    assert any("silently discards" in v.message for v in vs)


def test_ra06_typed_or_handled_excepts_are_clean(tmp_path):
    code = """\
        try:
            a()
        except ValueError:
            pass
        try:
            b()
        except Exception as e:
            log(e)
    """
    assert not _violations(tmp_path, "src/repro_torch/serve/x.py", code, "RA06")


def test_ra06_allowlisted_best_effort_file(tmp_path):
    code = "try:\n    a()\nexcept Exception:\n    pass\n"
    assert not _violations(tmp_path, "src/repro_torch/obs/bench.py", code, "RA06")


# ---------------------------------------------------------------------------
# Pragmas (RA00 hygiene)
# ---------------------------------------------------------------------------

def test_pragma_with_reason_suppresses(tmp_path):
    code = ("import time\n"
            "T = time.time()  # repro_torch: allow[RA01] -- fixture wants wall\n")
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code)
    ra01 = [v for v in vs if v.rule == "RA01"]
    assert len(ra01) == 1 and ra01[0].suppressed
    assert ra01[0].reason == "fixture wants wall"
    assert not [v for v in vs if v.rule == "RA00"]


def test_pragma_without_reason_rejected_and_nothing_suppressed(tmp_path):
    code = ("import time\n"
            "T = time.time()  # repro_torch: allow[RA01]\n")
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code)
    ra01 = [v for v in vs if v.rule == "RA01"]
    assert len(ra01) == 1 and not ra01[0].suppressed
    ra00 = [v for v in vs if v.rule == "RA00"]
    assert len(ra00) == 1 and "no reason" in ra00[0].message


def test_own_line_pragma_and_comment_block_continuation(tmp_path):
    code = ("import time\n"
            "# repro_torch: allow[RA01] -- measures real compute wall; the\n"
            "# reading feeds telemetry, never the virtual clock\n"
            "T = time.time()\n")
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code)
    ra01 = [v for v in vs if v.rule == "RA01"]
    assert len(ra01) == 1 and ra01[0].suppressed
    assert not [v for v in vs if v.rule == "RA00"]


def test_unused_and_unknown_pragmas_flagged(tmp_path):
    code = ("X = 1  # repro_torch: allow[RA01] -- nothing here violates it\n"
            "Y = 2  # repro_torch: allow[RA99] -- no such rule\n")
    vs = _violations(tmp_path, "src/repro_torch/serve/x.py", code, "RA00")
    msgs = " | ".join(v.message for v in vs)
    assert "unused suppression" in msgs and "unknown rule id" in msgs


def test_hard_rules_cannot_be_baselined(tmp_path):
    # an RA00 violation fails the run even with a fully matching baseline
    root = _tree(tmp_path, {
        "src/repro_torch/serve/x.py": "X = 1  # repro_torch: allow[RA01]\n"})
    ws = os.path.join(root, "ws.json")
    bl = os.path.join(root, "bl.json")
    wire.write_wire_schema(root, ws)
    engine.write_baseline(bl, {}, rules.config_fingerprint())
    res = engine.run_analysis(root, baseline_path=bl, wire_schema_path=ws,
                              max_violations=10_000)
    assert not res.ok
    assert any("[RA00]" in f for f in res.failures)


# ---------------------------------------------------------------------------
# Ratchet semantics
# ---------------------------------------------------------------------------

_CLOCK_SNIPPET = "import time\n\n\ndef now():\n    return time.time()\n"


def _toy_repo(tmp_path, code=_CLOCK_SNIPPET):
    root = _tree(tmp_path, {"src/repro_torch/serve/clock.py": code})
    bl = os.path.join(root, "baseline.json")
    ws = os.path.join(root, "wire_schema.json")
    wire.write_wire_schema(root, ws)
    return root, bl, ws


def _run(root, bl, ws, **kw):
    kw.setdefault("max_violations", 0)
    return engine.run_analysis(root, baseline_path=bl, wire_schema_path=ws,
                               **kw)


def test_missing_baseline_fails(tmp_path):
    root, bl, ws = _toy_repo(tmp_path)
    res = _run(root, bl, ws)
    assert not res.ok and any("no baseline" in f for f in res.failures)


def test_ratchet_regression_fails_and_budget_admits(tmp_path):
    root, bl, ws = _toy_repo(tmp_path)
    res = _run(root, bl, ws)
    assert res.counts == {"RA01:src/repro_torch/serve/clock.py": 1}
    engine.write_baseline(bl, res.counts, rules.config_fingerprint())
    assert _run(root, bl, ws).ok

    # a second wall-clock call regresses past the baseline
    p = Path(root, "src/repro_torch/serve/clock.py")
    p.write_text(p.read_text() + "\n\nT0 = time.time()\n")
    res = _run(root, bl, ws)
    assert not res.ok
    assert any(f.startswith("ratchet regression:") for f in res.failures)
    # ... unless the explicit MAX_LINT_VIOLATIONS budget covers the excess
    assert _run(root, bl, ws, max_violations=1).ok


def test_fixed_violation_must_lower_the_baseline(tmp_path):
    root, bl, ws = _toy_repo(tmp_path)
    res = _run(root, bl, ws)
    engine.write_baseline(bl, res.counts, rules.config_fingerprint())

    Path(root, "src/repro_torch/serve/clock.py").write_text(
        "def now(clock):\n    return clock.now_s\n")
    res = _run(root, bl, ws)
    assert not res.ok
    assert any(f.startswith("stale baseline:") for f in res.failures)
    # the budget never excuses a stale baseline — only regressions
    assert not _run(root, bl, ws, max_violations=50).ok
    engine.write_baseline(bl, res.counts, rules.config_fingerprint())
    assert _run(root, bl, ws).ok


def test_config_drift_fails(tmp_path):
    root, bl, ws = _toy_repo(tmp_path, code="X = 1\n")
    engine.write_baseline(bl, {}, "0" * 64)
    res = _run(root, bl, ws)
    assert not res.ok and any("config drift" in f for f in res.failures)


def test_max_violations_env_is_the_default_budget(tmp_path, monkeypatch):
    root, bl, ws = _toy_repo(tmp_path)
    engine.write_baseline(bl, {}, rules.config_fingerprint())
    monkeypatch.setenv("MAX_LINT_VIOLATIONS", "5")
    assert engine.run_analysis(root, baseline_path=bl,
                               wire_schema_path=ws).ok
    monkeypatch.setenv("MAX_LINT_VIOLATIONS", "0")
    assert not engine.run_analysis(root, baseline_path=bl,
                                   wire_schema_path=ws).ok


def test_json_report_schema(tmp_path):
    root, bl, ws = _toy_repo(tmp_path)
    engine.write_baseline(bl, {"RA01:src/repro_torch/serve/clock.py": 1},
                          rules.config_fingerprint())
    js = _run(root, bl, ws).to_json()
    assert js["schema"] == "repro-analysis/1"
    assert js["ok"] is True and js["failures"] == []
    assert js["files_scanned"] == 1
    assert js["counts_by_rule"] == {"RA01": 1}
    assert js["counts_by_key"] == {"RA01:src/repro_torch/serve/clock.py": 1}
    (v,) = js["violations"]
    assert set(v) == {"rule", "path", "line", "col", "message",
                      "suppressed", "reason"}
    json.loads(json.dumps(js))               # round-trips as plain JSON


# ---------------------------------------------------------------------------
# RA04 — wire fingerprints on the real modules
# ---------------------------------------------------------------------------

_WIRE_FILES = ("src/repro_torch/core/codec.py", "src/repro_torch/codec/container.py",
               "src/repro_torch/session/codec.py", "src/repro_torch/pipeline/op.py")


def _wire_tree(tmp_path):
    root = tmp_path / "wiretree"
    for rel in _WIRE_FILES:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO / rel, dst)
    schema = root / "wire_schema.json"
    shutil.copyfile(REPO / "src/repro_torch/analysis/wire_schema.json", schema)
    return root, schema


def test_committed_wire_schema_matches_the_tree():
    committed = json.loads(
        (REPO / "src/repro_torch/analysis/wire_schema.json").read_text())
    assert wire.build_wire_schema(str(REPO)) == committed


def test_wire_clean_tree_passes(tmp_path):
    root, schema = _wire_tree(tmp_path)
    vs, summary = wire.check_wire_schema(str(root), str(schema))
    assert vs == []
    assert {f: s["status"] for f, s in summary.items()} \
        == {"BaF2": "ok", "RTC1": "ok", "SSF1": "ok"}


def test_wire_layout_edit_without_bump_fails(tmp_path):
    root, schema = _wire_tree(tmp_path)
    codec = root / "src/repro_torch/session/codec.py"
    src = codec.read_text()
    assert '"<4sBBBBIIII"' in src
    codec.write_text(src.replace('"<4sBBBBIIII"', '"<4sBBBBIIIIH"'))
    vs, summary = wire.check_wire_schema(str(root), str(schema))
    assert summary["SSF1"]["status"] == "layout-changed-no-bump"
    assert any("without a codec_revision() bump" in v.message for v in vs)
    assert all(v.rule == "RA04" for v in vs)


def test_wire_bump_needs_regenerated_fingerprints(tmp_path):
    root, schema = _wire_tree(tmp_path)
    codec = root / "src/repro_torch/session/codec.py"
    codec.write_text(codec.read_text().replace(
        '"<4sBBBBIIII"', '"<4sBBBBIIIIH"'))
    op = root / "src/repro_torch/pipeline/op.py"
    op.write_text(op.read_text().replace(
        "SESSION_WIRE_VERSION = 1", "SESSION_WIRE_VERSION = 2"))
    vs, summary = wire.check_wire_schema(str(root), str(schema))
    assert summary["SSF1"]["status"] == "stale-fingerprint"
    assert any("stale wire_schema.json" in v.message for v in vs)
    # regenerating the fingerprints next to the bump makes the pass green
    wire.write_wire_schema(str(root), str(schema))
    vs2, summary2 = wire.check_wire_schema(str(root), str(schema))
    assert vs2 == [] and summary2["SSF1"]["status"] == "ok"
    assert "SESSION_WIRE_VERSION=2" in summary2["SSF1"]["revision"]


def test_wire_registered_family_cannot_silently_vanish(tmp_path):
    root, schema = _wire_tree(tmp_path)
    (root / "src/repro_torch/session/codec.py").unlink()
    vs, summary = wire.check_wire_schema(str(root), str(schema))
    assert summary["SSF1"]["status"] == "registered-but-absent"
    assert any("module(s) are gone" in v.message for v in vs)


def test_wire_absent_families_skip_on_toy_trees(tmp_path):
    root = _tree(tmp_path, {"src/repro_torch/serve/x.py": "X = 1\n"})
    ws = os.path.join(root, "ws.json")
    schema = wire.write_wire_schema(root, ws)
    assert schema["families"] == {}
    vs, summary = wire.check_wire_schema(root, ws)
    assert vs == []
    assert all(s["status"] == "absent" for s in summary.values())


# ---------------------------------------------------------------------------
# Negative control: a seeded wall clock in the real gateway must fail
# ---------------------------------------------------------------------------

def _seeded_gateway_tree(tmp_path):
    root = tmp_path / "seeded"
    rel = "src/repro_torch/serve/gateway.py"
    dst = root / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    lines = (REPO / rel).read_text().splitlines(keepends=True)
    i = next(n for n, line in enumerate(lines)
             if line.strip() == "while events:")
    indent = " " * (len(lines[i]) - len(lines[i].lstrip()))
    lines.insert(i, indent + "_wall = time.time()\n")
    dst.write_text("".join(lines))
    bl = root / "baseline.json"
    ws = root / "wire_schema.json"
    wire.write_wire_schema(str(root), str(ws))
    engine.write_baseline(str(bl), {}, rules.config_fingerprint())
    return root, bl, ws


def test_seeded_wall_clock_in_gateway_event_loop_fails(tmp_path):
    root, bl, ws = _seeded_gateway_tree(tmp_path)
    res = engine.run_analysis(str(root), baseline_path=str(bl),
                              wire_schema_path=str(ws), max_violations=0)
    assert not res.ok
    leaks = [v for v in res.unsuppressed()
             if v.rule == "RA01" and "time.time" in v.message]
    assert len(leaks) == 1
    # the gateway's own pragma'd perf_counter warm-timing sites stay quiet
    assert all("perf_counter" not in v.message for v in leaks)
    assert any("ratchet regression" in f and "RA01" in f
               for f in res.failures)


def test_cli_check_fails_on_seeded_tree(tmp_path):
    root, bl, ws = _seeded_gateway_tree(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               MAX_LINT_VIOLATIONS="0")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--root", str(root), "--baseline", str(bl),
         "--wire-schema", str(ws)],
        capture_output=True, text=True, env=env)
    assert proc.returncode == 1
    assert "CHECK FAILED" in proc.stderr
    assert "RA01" in proc.stdout + proc.stderr


def test_full_repo_check_passes():
    """The committed tree itself is clean: zero unsuppressed violations,
    every suppression reasoned, wire fingerprints current."""
    res = engine.run_analysis(str(REPO), max_violations=0)
    assert res.failures == []
    assert res.unsuppressed() == []
    assert all(v.reason for v in res.violations if v.suppressed)


# ---------------------------------------------------------------------------
# Autofixer
# ---------------------------------------------------------------------------

def test_fix_bare_except_with_real_body():
    src = "try:\n    a()\nexcept:\n    log()\n"
    fixed, applied = fixes.fix_source(src)
    assert "except Exception:" in fixed
    assert [f.rule for f in applied] == ["RA06"]
    # a *silent* bare except is a human decision, never autofixed
    silent = "try:\n    a()\nexcept:\n    pass\n"
    assert fixes.fix_source(silent) == (silent, [])


def test_fix_randomstate_to_default_rng():
    src = "import numpy as np\nr = np.random.RandomState(3)\n"
    fixed, applied = fixes.fix_source(src)
    assert "np.random.default_rng(3)" in fixed
    assert applied and applied[0].rule == "RA02"


def test_fix_seeded_global_api_rewrites_onto_generator():
    src = textwrap.dedent("""\
        import numpy as np

        np.random.seed(7)
        x = np.random.rand(3, 4)
        y = np.random.randn(2)
        i = np.random.randint(0, 9)
    """)
    fixed, applied = fixes.fix_source(src)
    assert "rng = np.random.default_rng(7)" in fixed
    assert "rng.random((3, 4))" in fixed
    assert "rng.standard_normal((2,))" in fixed
    assert "rng.integers(0, 9)" in fixed
    # the rewrite executes and keeps the legacy calling conventions
    ns = {}
    exec(fixed, ns)
    assert ns["x"].shape == (3, 4) and ns["y"].shape == (2,)
    assert 0 <= ns["i"] < 9
    # idempotent: a second --fix is a no-op
    assert fixes.fix_source(fixed) == (fixed, [])


def test_fix_output_is_ra02_clean(tmp_path):
    src = "import numpy as np\n\nnp.random.seed(1)\nx = np.random.rand(3)\n"
    fixed, _ = fixes.fix_source(src)
    assert not _violations(tmp_path, "src/repro_torch/models/x.py", fixed, "RA02")


def test_fix_leaves_unseeded_legacy_for_a_human():
    src = "import numpy as np\nx = np.random.rand(3)\n"
    assert fixes.fix_source(src) == (src, [])


# ---------------------------------------------------------------------------
# Replay sanitizer (unit level; the SessionManager wiring lives in
# tests/test_session.py next to the gateway fixtures)
# ---------------------------------------------------------------------------

def test_sanitizer_blocks_wall_clock_and_global_rng():
    with replay_sanitizer():
        with pytest.raises(ReplaySanitizerError, match="virtual clock"):
            time.time()
        with pytest.raises(ReplaySanitizerError, match="Generator"):
            # repro: allow[RA02] -- asserts the sanitizer blocks this call
            # repro_torch: allow[RA02] -- asserts the sanitizer blocks this call
            np.random.rand(2)
        with pytest.raises(ReplaySanitizerError, match="Generator"):
            # repro: allow[RA02] -- asserts the sanitizer blocks this call
            # repro_torch: allow[RA02] -- asserts the sanitizer blocks this call
            random.random()
        # the sanctioned APIs keep working mid-replay
        assert time.perf_counter() > 0
        assert np.random.default_rng(0).random() == \
            np.random.default_rng(0).random()
        assert random.Random(0).random() == random.Random(0).random()
    # everything restored on exit
    assert time.time() > 0
    # repro: allow[RA02] -- proves the patch was restored
    # repro_torch: allow[RA02] -- proves the patch was restored
    assert np.random.rand(2).shape == (2,)


def test_sanitizer_strict_forbids_perf_counter_too():
    with replay_sanitizer(strict=True):
        with pytest.raises(ReplaySanitizerError):
            time.perf_counter()
    assert time.perf_counter() > 0


def test_sanitizer_restores_after_an_exception():
    with pytest.raises(ValueError):
        with replay_sanitizer():
            raise ValueError("boom")
    assert time.time() > 0


# ---------------------------------------------------------------------------
# The port beside the reference
# ---------------------------------------------------------------------------

def test_wire_fingerprints_equal_the_references():
    """The fingerprints hash no paths: the port's committed BaF2/RTC1/SSF1
    entries equal the reference's, family by family."""
    port = json.loads(
        (REPO / "src/repro_torch/analysis/wire_schema.json").read_text())
    ref = json.loads((REPO / "src/repro/analysis/wire_schema.json").read_text())
    assert sorted(port["families"]) == sorted(ref["families"])
    for family, entry in ref["families"].items():
        assert port["families"][family]["revision"] == entry["revision"]
        assert port["families"][family]["layout_sha256"] \
            == entry["layout_sha256"]


def test_each_linter_ignores_the_others_pragmas(tmp_path):
    """A ``repro_torch:`` pragma is invisible to the reference's linter and
    a ``repro:`` pragma to the port's: neither suppresses, neither is an
    unused suppression (RA00) to the other."""
    from repro.analysis import engine as ref_engine
    code = "import time\nT = time.time()  # repro_torch: allow[RA01] -- x\n"
    root = _tree(tmp_path / "a", {"src/repro/serve/x.py": code,
                                  "src/repro_torch/serve/x.py": code})
    _, ref = ref_engine.analyze_file(root, "src/repro/serve/x.py")
    assert [v.rule for v in ref] == ["RA01"] and not ref[0].suppressed
    _, port = engine.analyze_file(root, "src/repro_torch/serve/x.py")
    assert [v.rule for v in port] == ["RA01"] and port[0].suppressed
    legacy = code.replace("repro_torch:", "repro:")
    root = _tree(tmp_path / "b", {"src/repro_torch/serve/x.py": legacy})
    _, port = engine.analyze_file(root, "src/repro_torch/serve/x.py")
    assert [v.rule for v in port] == ["RA01"] and not port[0].suppressed


def test_port_baseline_is_empty_and_scopes_name_the_port():
    base = engine.load_baseline(
        str(REPO / "src/repro_torch/analysis/baseline.json"))
    assert base["violations"] == {}
    for key in ("virtual_clock_scope", "set_iteration_scope",
                "host_sync_scope", "build_scope"):
        assert all(p.startswith("src/repro_torch/")
                   for p in rules.CONFIG[key])
    files = engine.discover_files(str(REPO))
    assert "chip_smoke.py" in files and "tests/test_torch_analysis.py" \
        in files and not any(f.startswith("src/repro/") for f in files)
