"""Rule registry for the invariant linter.

Each rule is a function ``check(ctx) -> list[Violation]`` over one parsed
file, registered in :data:`RULES` with an id, a one-line title, and the
regression class it guards against. Rules are pure AST + config — no
imports of the code under analysis, no third-party deps — so the pass runs
identically on a tree that does not even import (a syntax error is itself
reported, not crashed on).

Scoping and allowlists live in :data:`CONFIG`; :func:`config_fingerprint`
hashes the whole configuration (rule ids included) into the baseline file so
CI fails on silent config drift — loosening a scope is a reviewed change,
exactly like raising the tier-1 failure budget would be.
"""
from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.analysis.engine import FileContext, Violation

# ---------------------------------------------------------------------------
# Configuration (hashed into the baseline; edits are config drift)
# ---------------------------------------------------------------------------

CONFIG: dict = {
    # RA01: files under these prefixes must never read a wall clock. obs/ is
    # in scope because the tracer (obs/trace.py) must stay on the gateway's
    # VIRTUAL clock for byte-identical trace JSON; hooks.py is the one
    # sanctioned wall-clock sink (stage timers, never trace/telemetry input).
    "virtual_clock_scope": [
        "src/repro_torch/serve/", "src/repro_torch/session/", "src/repro_torch/codec/",
        "src/repro_torch/pipeline/", "src/repro_torch/obs/", "src/repro_torch/tasks/",
    ],
    "virtual_clock_allow_files": {
        "src/repro_torch/obs/hooks.py":
            "the sanctioned wall-clock measurement sink: stage timers feed "
            "metrics histograms only, never the trace or replay state",
    },
    "wall_clock_calls": [
        "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
        "time.perf_counter", "time.perf_counter_ns",
        "time.process_time", "time.process_time_ns",
        "time.localtime", "time.gmtime", "time.ctime", "time.strftime",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    ],
    # RA02: legacy global-state RNG entry points (numpy legacy API + stdlib
    # random module). torch.Generator / np.random.Generator are the sanctioned
    # explicit-state APIs and are never flagged.
    "legacy_np_random": [
        "rand", "randn", "randint", "random", "random_sample", "ranf",
        "sample", "choice", "shuffle", "permutation", "uniform", "normal",
        "standard_normal", "beta", "binomial", "poisson", "exponential",
        "seed", "get_state", "set_state", "RandomState",
    ],
    "legacy_py_random": [
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "normalvariate", "betavariate",
        "expovariate", "seed", "getrandbits",
    ],
    # RA02b: set-iteration order must not reach wire bytes / schedules /
    # serialized output; scoped to the modules that produce them.
    "set_iteration_scope": [
        "src/repro_torch/serve/", "src/repro_torch/session/", "src/repro_torch/codec/",
        "src/repro_torch/core/", "src/repro_torch/pipeline/", "src/repro_torch/obs/",
        "src/repro_torch/tasks/",
    ],
    # RA03: the one module that builds and loads the CUDA kernels.
    "build_scope": ["src/repro_torch/"],
    "build_modules": ["src/repro_torch/kernels/_build.py"],
    "native_loaders": [
        "ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
        "ctypes.CDLL.LoadLibrary", "torch.ops.load_library",
        "torch.utils.cpp_extension.load",
        "torch.utils.cpp_extension.load_inline",
    ],
    # RA05: host-sync calls inside captured (CUDA graph) or compiled
    # (torch.compile) regions.
    "host_sync_scope": ["src/repro_torch/"],
    "compile_entries": ["torch.compile"],
    "capture_entries": ["torch.cuda.graph"],
    # RA06: best-effort sites where a silent catch-all is the contract.
    # obs/bench.py is the canonical example: git_sha() falls back to
    # $GITHUB_SHA — but even there the except is narrowed to the concrete
    # (SubprocessError, OSError) pair, so the allowlist entry documents the
    # contract rather than hiding a blanket handler.
    "silent_except_allow_files": {
        "src/repro_torch/obs/bench.py":
            "best-effort git metadata: every failure path falls back to "
            "$GITHUB_SHA / 'unknown'; handlers stay typed regardless",
    },
}


def config_fingerprint() -> str:
    """Hash of everything that changes what the pass flags."""
    payload = {"config": CONFIG, "rules": sorted(RULES)}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

def build_alias_map(tree: ast.AST) -> dict[str, str]:
    """Local name -> dotted origin, from every import in the file.

    ``import numpy as np`` -> {"np": "numpy"}; ``from time import
    perf_counter`` -> {"perf_counter": "time.perf_counter"}; ``from datetime
    import datetime`` -> {"datetime": "datetime.datetime"}. Function-level
    imports are folded in too — resolution is per-file, not per-scope, which
    is the right bias for a linter (a shadowed import is its own smell).
    """
    alias: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    alias[a.asname] = a.name
                else:
                    alias[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                alias[a.asname or a.name] = f"{node.module}.{a.name}"
    return alias


def dotted_parts(node: ast.AST) -> list[str] | None:
    """['np', 'random', 'rand'] for the expression ``np.random.rand``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def resolve(alias: dict[str, str], node: ast.AST) -> str | None:
    """Fully-qualified dotted name of an expression, through the imports."""
    parts = dotted_parts(node)
    if not parts:
        return None
    head = alias.get(parts[0], parts[0])
    return ".".join([head] + parts[1:])


def _in_scope(path: str, prefixes: list[str]) -> bool:
    return any(path.startswith(p) for p in prefixes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    guards: str                          # the regression class this catches
    check: Callable[[FileContext], list]
    fixable: bool = False


RULES: dict[str, Rule] = {}


def _register(rule: Rule) -> Rule:
    RULES[rule.id] = rule
    return rule


def _v(rule_id: str, ctx: FileContext, node: ast.AST, message: str) -> Violation:
    return Violation(rule=rule_id, path=ctx.path,
                     line=getattr(node, "lineno", 1),
                     col=getattr(node, "col_offset", 0), message=message)


# ---------------------------------------------------------------------------
# RA01 — virtual-clock purity
# ---------------------------------------------------------------------------

def _check_ra01(ctx: FileContext) -> list:
    if not _in_scope(ctx.path, CONFIG["virtual_clock_scope"]):
        return []
    if ctx.path in CONFIG["virtual_clock_allow_files"]:
        return []
    wall = set(CONFIG["wall_clock_calls"])
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = resolve(ctx.alias, node.func)
            if name in wall:
                out.append(_v("RA01", ctx, node,
                              f"wall-clock call {name}() on a virtual-clock "
                              f"path; replay gates require the event-loop "
                              f"clock (or an allowlisted measurement site)"))
    return out


_register(Rule(
    id="RA01", title="virtual-clock purity", check=_check_ra01,
    guards="one time.time() in serve/session/codec/pipeline/obs breaks "
           "bit-identical replay, byte-identical traces, and session "
           "signatures all at once"))


# ---------------------------------------------------------------------------
# RA02 — determinism: legacy RNG + set-iteration order
# ---------------------------------------------------------------------------

def _is_setish(node: ast.AST, alias: dict[str, str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = resolve(alias, node.func)
        if name in ("set", "frozenset"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_setish(node.left, alias)
                or _is_setish(node.right, alias))
    return False


def _check_ra02(ctx: FileContext) -> list:
    out = []
    np_legacy = set(CONFIG["legacy_np_random"])
    py_legacy = set(CONFIG["legacy_py_random"])
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = resolve(ctx.alias, node.func)
            if not name:
                continue
            parts = name.split(".")
            if (len(parts) == 3 and parts[0] == "numpy"
                    and parts[1] == "random" and parts[2] in np_legacy):
                out.append(_v("RA02", ctx, node,
                              f"legacy global-state RNG {name}(); thread an "
                              f"explicit np.random.Generator "
                              f"(np.random.default_rng(seed)) instead"))
            elif (len(parts) == 2 and parts[0] == "random"
                    and parts[1] in py_legacy):
                out.append(_v("RA02", ctx, node,
                              f"stdlib global-state RNG {name}(); use an "
                              f"explicit random.Random(seed) or "
                              f"np.random.default_rng(seed)"))
    if _in_scope(ctx.path, CONFIG["set_iteration_scope"]):
        # results consumed by an order-insensitive reducer are fine:
        # sorted(x for x in set(...)) is the *fix*, not a violation, and a
        # SetComp built from a set stays unordered by construction.
        unordered_ok: set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = resolve(ctx.alias, node.func)
                if name in ("sorted", "min", "max", "sum", "any", "all",
                            "len", "set", "frozenset"):
                    for a in node.args:
                        unordered_ok.add(id(a))

        def flag_iter(it: ast.AST) -> None:
            if _is_setish(it, ctx.alias):
                out.append(_v("RA02", ctx, it,
                              "iteration over a set: ordering is "
                              "hash-randomized and must never reach wire "
                              "bytes, schedules, or serialized output — "
                              "wrap in sorted(...)"))
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                flag_iter(node.iter)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp)):
                if id(node) in unordered_ok:
                    continue
                for gen in node.generators:
                    flag_iter(gen.iter)
            elif isinstance(node, ast.Call):
                name = resolve(ctx.alias, node.func)
                if name in ("list", "tuple", "enumerate") and node.args:
                    flag_iter(node.args[0])
    return out


_register(Rule(
    id="RA02", title="determinism: no unseeded/global RNG, no set-order "
                     "into wire bytes or schedules",
    check=_check_ra02, fixable=True,
    guards="hash-randomized or process-global entropy feeding wire bytes, "
           "scheduler order, or serialized output silently breaks replay "
           "signatures and RD caches"))


# ---------------------------------------------------------------------------
# RA03 — build discipline (CUDA code is built and loaded in one module)
# ---------------------------------------------------------------------------

def _check_ra03(ctx: FileContext) -> list:
    if not _in_scope(ctx.path, CONFIG["build_scope"]):
        return []
    if ctx.path in CONFIG["build_modules"]:
        return []
    loaders = set(CONFIG["native_loaders"])
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("torch.utils.cpp_extension"):
                    out.append(_v("RA03", ctx, node,
                                  f"import of {a.name}: kernels are built "
                                  f"only by kernels/_build.py"))
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith("torch.utils.cpp_extension") or (
                    node.module == "torch.utils" and any(
                        a.name == "cpp_extension" for a in node.names)):
                out.append(_v("RA03", ctx, node,
                              f"'from {node.module} import ...': kernels "
                              f"are built only by kernels/_build.py"))
        elif isinstance(node, ast.Call):
            name = resolve(ctx.alias, node.func)
            if name in loaders:
                out.append(_v("RA03", ctx, node,
                              f"{name}() loads native code outside "
                              f"kernels/_build.py: build and load every "
                              f"kernel there, so each has one launch "
                              f"count and one build path"))
    return out


_register(Rule(
    id="RA03", title="build discipline: CUDA code is built and loaded only "
                     "in kernels/_build.py",
    check=_check_ra03,
    guards="a second build or load path gives a kernel that chip_smoke.py "
           "never builds from the checkout and whose launches no count "
           "sees"))


# ---------------------------------------------------------------------------
# RA05 — host-sync inside captured or compiled regions
# ---------------------------------------------------------------------------

_HOST_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _captured_regions(ctx: FileContext) -> list[tuple[str, list]]:
    """(label, nodes) of every region that is compiled (a function given to
    or decorated with ``torch.compile``) or captured (the body of ``with
    torch.cuda.graph(...)``)."""
    defs: dict[str, list] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    regions: list[tuple[str, list]] = []
    compiled: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if resolve(ctx.alias, target) in CONFIG["compile_entries"]:
                    regions.append((f"compiled body {node.name}()", [node]))
        elif isinstance(node, ast.Call):
            if resolve(ctx.alias, node.func) in CONFIG["compile_entries"]:
                for a in node.args[:1]:
                    if isinstance(a, ast.Name):
                        compiled.add(a.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and resolve(
                        ctx.alias, expr.func) in CONFIG["capture_entries"]:
                    regions.append(("a captured CUDA graph", node.body))
    for name in sorted(compiled):
        for fn in defs.get(name, []):
            regions.append((f"compiled body {name}()", [fn]))
    return regions


def _check_ra05(ctx: FileContext) -> list:
    if not _in_scope(ctx.path, CONFIG["host_sync_scope"]):
        return []
    out = []
    seen: set[int] = set()
    for where, body in _captured_regions(ctx):
        for root in body:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _HOST_SYNC_METHODS
                        and not node.args):
                    out.append(_v("RA05", ctx, node,
                                  f".{node.func.attr}() inside {where}: a "
                                  f"host sync (a graph break under "
                                  f"torch.compile, an error or a stale "
                                  f"value under capture)"))
                    continue
                name = resolve(ctx.alias, node.func)
                if name in ("numpy.asarray", "numpy.array"):
                    out.append(_v("RA05", ctx, node,
                                  f"{name}() inside {where}: copies to the "
                                  f"host; keep the region on the card"))
    return out


_register(Rule(
    id="RA05", title="no host-sync (.item()/.cpu()/.tolist()/.numpy()/"
                     "np.asarray) in captured or compiled regions",
    check=_check_ra05,
    guards="host syncs inside torch.compile or CUDA-graph regions break the "
           "graph or replay a value captured once"))


# ---------------------------------------------------------------------------
# RA06 — silent failure
# ---------------------------------------------------------------------------

def _silent_body(body: list[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant):
            continue                      # docstring / Ellipsis
        return False
    return True


def _check_ra06(ctx: FileContext) -> list:
    if ctx.path in CONFIG["silent_except_allow_files"]:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(_v("RA06", ctx, node,
                          "bare 'except:' swallows KeyboardInterrupt and "
                          "SystemExit too; name the concrete exception "
                          "types"))
            continue
        name = resolve(ctx.alias, node.type)
        if name in ("Exception", "BaseException") and _silent_body(node.body):
            out.append(_v("RA06", ctx, node,
                          f"'except {name}: pass' silently discards every "
                          f"failure; narrow to the concrete types or "
                          f"handle/log the error"))
    return out


_register(Rule(
    id="RA06", title="no silent catch-alls", check=_check_ra06, fixable=True,
    guards="a swallowed exception on a serving or codec path turns a loud "
           "failure into a wrong-bytes one"))


# RA04 lives in repro_torch.analysis.wire (it is cross-file: formats + revision
# constants + the committed fingerprint file); importing it here would cycle.
RA04_ID = "RA04"
RA04_TITLE = ("wire-format hygiene: pack/unpack symmetry, CRC coverage, and "
              "fingerprinted layouts that fail the build when edited without "
              "a codec_revision() bump")


# RA00 is the meta-rule for pragma hygiene (reason mandatory, no unused or
# unknown suppressions). It is emitted by the engine, never baselined.
RA00_ID = "RA00"
