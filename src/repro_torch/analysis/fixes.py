"""``--fix``: autofixes for the mechanical rules (RA02 legacy RNG, RA06).

Only rewrites with an unambiguous mechanical translation are applied:

  * **RA06** — a bare ``except:`` whose body actually handles something
    becomes ``except Exception:`` (typed, no longer swallows
    ``KeyboardInterrupt``/``SystemExit``). A *silent* handler
    (``except: pass``) is NOT autofixed: only a human knows which concrete
    failure is expected there.
  * **RA02** — ``np.random.RandomState(seed)`` becomes
    ``np.random.default_rng(seed)``; a module using the legacy seeded
    global API (``np.random.seed(N)`` followed by ``np.random.rand(...)``
    etc.) is rewritten onto an explicit generator::

        np.random.seed(7)            ->  rng = np.random.default_rng(7)
        x = np.random.rand(3, 4)     ->  x = rng.random((3, 4))
        i = np.random.randint(0, 9)  ->  i = rng.integers(0, 9)

    Unseeded legacy calls (no ``np.random.seed`` in the file) are left for
    a human: inventing a seed would hide the bug the rule exists to catch.

Fixes are AST-located, text-applied (comments and formatting survive), and
idempotent — a second ``--fix`` run is a no-op.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from repro_torch.analysis.rules import (_silent_body, build_alias_map,
                                  dotted_parts, resolve)

# legacy np.random function -> (Generator method, wrap positional args in a
# shape tuple — the rand/randn calling convention difference)
_GEN_METHOD = {
    "rand": ("random", True),
    "randn": ("standard_normal", True),
    "randint": ("integers", False),
    "random": ("random", False),
    "random_sample": ("random", False),
    "ranf": ("random", False),
    "sample": ("random", False),
    "choice": ("choice", False),
    "shuffle": ("shuffle", False),
    "permutation": ("permutation", False),
    "uniform": ("uniform", False),
    "normal": ("normal", False),
    "standard_normal": ("standard_normal", False),
}


@dataclass(frozen=True)
class Fix:
    rule: str
    line: int
    description: str


def _line_offsets(source: str) -> list[int]:
    offsets, pos = [0], 0
    for line in source.splitlines(keepends=True):
        pos += len(line)
        offsets.append(pos)
    return offsets


class _Edits:
    def __init__(self, source: str):
        self.source = source
        self.offsets = _line_offsets(source)
        self.edits: list[tuple[int, int, str]] = []

    def at(self, lineno: int, col: int) -> int:
        return self.offsets[lineno - 1] + col

    def replace(self, node: ast.AST, text: str) -> None:
        self.edits.append((self.at(node.lineno, node.col_offset),
                           self.at(node.end_lineno, node.end_col_offset),
                           text))

    def insert(self, lineno: int, col: int, text: str) -> None:
        pos = self.at(lineno, col)
        self.edits.append((pos, pos, text))

    def apply(self) -> str:
        out = self.source
        for start, end, text in sorted(self.edits, reverse=True):
            out = out[:start] + text + out[end:]
        return out


def fix_source(source: str) -> tuple[str, list[Fix]]:
    """Apply every mechanical fix; returns (new source, applied fixes)."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return source, []
    alias = build_alias_map(tree)
    edits = _Edits(source)
    fixes: list[Fix] = []

    # ---- RA06: bare except with a real body -> except Exception ----------
    for node in ast.walk(tree):
        if (isinstance(node, ast.ExceptHandler) and node.type is None
                and not _silent_body(node.body)):
            # the handler node starts at the 'except' keyword
            pos = edits.at(node.lineno, node.col_offset)
            if source[pos:pos + 6] == "except":
                edits.edits.append((pos, pos + 6, "except Exception"))
                fixes.append(Fix("RA06", node.lineno,
                                 "bare 'except:' -> 'except Exception:'"))

    # ---- RA02: numpy legacy RNG ------------------------------------------
    def np_random_fn(call: ast.Call) -> str | None:
        name = resolve(alias, call.func)
        if not name:
            return None
        parts = name.split(".")
        if len(parts) == 3 and parts[:2] == ["numpy", "random"]:
            return parts[2]
        return None

    def src_of(node: ast.AST) -> str:
        return ast.get_source_segment(source, node) or ""

    # RandomState(seed) -> default_rng(seed), wherever it appears
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and np_random_fn(node) == "RandomState":
            prefix = ".".join(dotted_parts(node.func)[:-1])
            edits.replace(node.func, f"{prefix}.default_rng")
            fixes.append(Fix("RA02", node.lineno,
                             "np.random.RandomState -> "
                             "np.random.default_rng"))

    # seeded global API -> explicit generator
    seed_stmts = [
        stmt for stmt in ast.walk(tree)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
        and np_random_fn(stmt.value) == "seed"]
    if seed_stmts:
        first_seed = min(seed_stmts, key=lambda s: s.lineno)
        module_names = {n.id for n in ast.walk(tree)
                        if isinstance(n, ast.Name)}
        rng = "rng" if "rng" not in module_names else "_repro_rng"
        for stmt in seed_stmts:
            call = stmt.value
            prefix = ".".join(dotted_parts(call.func)[:-1])
            head = (f"{rng} = {prefix}.default_rng"
                    if stmt is first_seed else f"{rng} = {prefix}.default_rng")
            edits.replace(call.func, head)
            fixes.append(Fix("RA02", stmt.lineno,
                             f"np.random.seed(...) -> {rng} = "
                             f"np.random.default_rng(...)"))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or node.lineno <= \
                    first_seed.lineno:
                continue
            fn = np_random_fn(node)
            if fn not in _GEN_METHOD:
                continue
            method, tuple_args = _GEN_METHOD[fn]
            edits.replace(node.func, f"{rng}.{method}")
            if tuple_args and len(node.args) >= 1:
                args_txt = ", ".join(src_of(a) for a in node.args)
                wrapped = (f"({args_txt},)" if len(node.args) == 1
                           else f"({args_txt})")
                first, last = node.args[0], node.args[-1]
                edits.edits.append((
                    edits.at(first.lineno, first.col_offset),
                    edits.at(last.end_lineno, last.end_col_offset),
                    wrapped))
            fixes.append(Fix("RA02", node.lineno,
                             f"np.random.{fn} -> {rng}.{method}"))

    if not fixes:
        return source, []
    return edits.apply(), fixes


def fix_file(path: str) -> list[Fix]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    fixed, fixes = fix_source(source)
    if fixes and fixed != source:
        with open(path, "w", encoding="utf-8") as f:
            f.write(fixed)
    return fixes
