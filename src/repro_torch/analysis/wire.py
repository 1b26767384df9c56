"""RA04 — wire-format hygiene and fingerprinted layouts.

Three wire families leave this repo: **BaF2** (the EncodedTensor container,
``core/codec.py``), **RTC1** (the rANS container, ``codec/container.py``)
and **SSF1** (session frames, ``session/codec.py``). Their layouts are
replayed, cached (RD tables key on :func:`repro_torch.serve.codec_revision`) and
fuzzed byte-for-byte, so an edit to any ``struct`` format string without a
revision bump silently invalidates every one of those guarantees.

This module extracts, per family and purely from the AST:

  * every ``struct`` format string (``struct.Struct``/``pack``/``pack_into``
    /``unpack``/``unpack_from``/``calcsize``), f-string formats canonicalized
    with ``{}`` placeholders,
  * the revision constants that :func:`repro_torch.serve.codec_revision` (or the
    session header) is built from — magic bytes + version ints,
  * whether the module computes a CRC (``zlib.crc32``/``adler32``) at all,

and checks them against the committed ``wire_schema.json``:

  * layout changed, revision unchanged  -> **RA04**: bump the revision
    constant (that is what "codec_revision() bump" means mechanically);
  * revision changed (with or without a layout change) -> **RA04**: the
    fingerprint file is stale; regenerate with ``--update-wire-schema`` so
    the new layout is committed and reviewed next to the bump;
  * a pack format with no matching unpack/Struct, or a family module with
    no CRC call -> **RA04** directly.

RA04 findings are *hard*: never baselined, never pragma-suppressed — a wire
change is correct only when the fingerprint file changes with it.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os

from repro_torch.analysis.engine import Violation

WIRE_SCHEMA_VERSION = "repro-wire-schema/1"

# family -> modules holding its struct formats,
#           [(module, constant name), ...] forming its revision identity,
#           crc_modules: where the CRC discipline covering its payload
#           bytes lives. BaF2 delegates: its header is validated
#           structurally (magic + explicit side-info/payload lengths +
#           trailing-garbage rejection) and its payload integrity is the
#           entropy backend's — RTC1 CRCs for rans/rans-ctx, zlib's
#           built-in adler32 for zlib — so the delegate is the RTC1
#           module. Adding a header CRC to BaF2 itself would change the
#           wire layout and break every bit-identical gate; if that trade
#           is ever taken it must ride a codec_revision() bump.
FAMILIES: dict[str, dict] = {
    "BaF2": {
        "modules": ["src/repro_torch/core/codec.py"],
        "crc_modules": ["src/repro_torch/codec/container.py"],
        "revision_consts": [
            ("src/repro_torch/core/codec.py", "MAGIC"),
            ("src/repro_torch/pipeline/op.py", "WIRE_PROFILE_VERSION"),
        ],
    },
    "RTC1": {
        "modules": ["src/repro_torch/codec/container.py"],
        "crc_modules": ["src/repro_torch/codec/container.py"],
        "revision_consts": [
            ("src/repro_torch/codec/container.py", "MAGIC"),
            ("src/repro_torch/codec/container.py", "VERSION"),
        ],
    },
    "SSF1": {
        "modules": ["src/repro_torch/session/codec.py"],
        "crc_modules": ["src/repro_torch/session/codec.py"],
        "revision_consts": [
            ("src/repro_torch/session/codec.py", "SESSION_MAGIC"),
            ("src/repro_torch/pipeline/op.py", "SESSION_WIRE_VERSION"),
        ],
    },
}

_STRUCT_FNS = {"Struct": "struct", "calcsize": "both",
               "pack": "pack", "pack_into": "pack",
               "unpack": "unpack", "unpack_from": "unpack"}


def _canonical_format(node: ast.AST) -> str | None:
    """Format-string argument as a canonical text; ``{}`` for dynamic parts."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.replace(" ", "")
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value.replace(" ", ""))
            else:
                parts.append("{}")
        return "".join(parts)
    return None


def _module_formats(tree: ast.AST) -> tuple[list[dict], bool]:
    """([{kind, format}, ...] sorted, module references a CRC at all)."""
    from repro_torch.analysis.rules import build_alias_map, resolve
    alias = build_alias_map(tree)
    found: list[dict] = []
    has_crc = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = resolve(alias, node.func) or ""
        parts = name.split(".")
        if parts[-1] in ("crc32", "adler32"):
            has_crc = True
        if (len(parts) >= 2 and parts[-2] == "struct"
                and parts[-1] in _STRUCT_FNS and node.args):
            fmt = _canonical_format(node.args[0])
            if fmt is not None:
                found.append({"kind": _STRUCT_FNS[parts[-1]], "format": fmt})
    found.sort(key=lambda d: (d["format"], d["kind"]))
    return found, has_crc


def _module_constant(tree: ast.AST, name: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name and isinstance(
                        node.value, ast.Constant):
                    return node.value.value
    return None


def _parse(root: str, rel: str) -> ast.AST | None:
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            return ast.parse(f.read(), filename=rel)
    except (OSError, SyntaxError):
        return None


def extract_family(root: str, family: str) -> dict | None:
    """{"revision": str, "formats": [...], "layout_sha256": str} or None
    when a family module is missing/unparseable (reported by the caller)."""
    spec = FAMILIES[family]
    formats: list[dict] = []
    for rel in spec["modules"]:
        tree = _parse(root, rel)
        if tree is None:
            return None
        fmts, _ = _module_formats(tree)
        formats.extend(fmts)
    crc_ok = True
    for rel in spec.get("crc_modules", spec["modules"]):
        tree = _parse(root, rel)
        if tree is None:
            return None
        _, has_crc = _module_formats(tree)
        crc_ok = crc_ok and has_crc
    rev_parts: list[str] = []
    for rel, const in spec["revision_consts"]:
        tree = _parse(root, rel)
        value = _module_constant(tree, const) if tree is not None else None
        if value is None:
            return None
        if isinstance(value, bytes):
            value = value.decode("ascii", "backslashreplace")
        rev_parts.append(f"{const}={value}")
    formats.sort(key=lambda d: (d["format"], d["kind"]))
    blob = json.dumps(formats, sort_keys=True, separators=(",", ":"))
    return {"revision": "/".join(rev_parts), "formats": formats,
            "layout_sha256": hashlib.sha256(blob.encode()).hexdigest(),
            "has_crc": crc_ok}


def build_wire_schema(root: str) -> dict:
    families = {}
    for family in sorted(FAMILIES):
        ext = extract_family(root, family)
        if ext is not None:
            families[family] = {"revision": ext["revision"],
                                "layout_sha256": ext["layout_sha256"],
                                "formats": ext["formats"]}
    return {"schema": WIRE_SCHEMA_VERSION, "families": families}


def write_wire_schema(root: str, path: str) -> dict:
    schema = build_wire_schema(root)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(schema, f, indent=1, sort_keys=True)
        f.write("\n")
    return schema


def _strip_endian(fmt: str) -> str:
    return fmt.lstrip("<>=!@")


def _hygiene(family: str, ext: dict) -> list[Violation]:
    """Per-family pack/unpack symmetry + CRC coverage.

    Symmetry is prefix-aware: a packed field sequence is readable when some
    unpack/Struct format *starts with* it — e.g. RTC1 packs the chunk CRC
    body as ``"<II"`` + payload and reads it back through the ``"<III"``
    (count|n_words|crc) Struct.
    """
    spec = FAMILIES[family]
    path = spec["modules"][0]
    out: list[Violation] = []
    packs = {d["format"] for d in ext["formats"] if d["kind"] == "pack"}
    unpacks = {d["format"] for d in ext["formats"]
               if d["kind"] in ("unpack", "struct", "both")}
    readable = {_strip_endian(f) for f in unpacks}
    for fmt in sorted(packs):
        bare = _strip_endian(fmt)
        if not any(r.startswith(bare) for r in readable):
            out.append(Violation(
                rule="RA04", path=path, line=1, col=0,
                message=f"{family}: pack format {fmt!r} has no matching "
                        f"unpack/Struct in the family module — a "
                        f"write-only layout cannot round-trip"))
    if not ext["has_crc"]:
        crc_mods = spec.get("crc_modules", spec["modules"])
        out.append(Violation(
            rule="RA04", path=path, line=1, col=0,
            message=f"{family}: no CRC (zlib.crc32/adler32) in its "
                    f"integrity module(s) {crc_mods}; wire integrity "
                    f"checks are mandatory for every format"))
    return out


def check_wire_schema(root: str, schema_path: str) -> tuple[list[Violation],
                                                            dict]:
    """All RA04 violations + a per-family summary for the JSON report."""
    violations: list[Violation] = []
    summary: dict = {}
    try:
        with open(schema_path, encoding="utf-8") as f:
            committed = json.load(f)
        if committed.get("schema") != WIRE_SCHEMA_VERSION:
            raise ValueError(f"unsupported wire schema "
                             f"{committed.get('schema')!r}")
        committed_families = committed.get("families", {})
    except FileNotFoundError:
        committed_families = None
        violations.append(Violation(
            rule="RA04", path=os.path.relpath(schema_path, root), line=1,
            col=0, message="no committed wire_schema.json; run 'python -m "
                           "repro_torch.analysis --update-wire-schema' and commit "
                           "the fingerprints"))
    except ValueError as e:
        committed_families = None
        violations.append(Violation(
            rule="RA04", path=os.path.relpath(schema_path, root), line=1,
            col=0, message=f"bad wire schema file: {e}"))

    for family in sorted(FAMILIES):
        spec = FAMILIES[family]
        mod = spec["modules"][0]
        present = any(os.path.exists(os.path.join(root, rel))
                      for rel in spec["modules"])
        if not present:
            # a tree without the family at all (test fixtures, partial
            # checkouts) has nothing to fingerprint — unless the committed
            # schema says the family should exist, in which case its
            # disappearance IS a wire change
            if committed_families and family in committed_families:
                violations.append(Violation(
                    rule="RA04", path=mod, line=1, col=0,
                    message=f"{family}: registered in wire_schema.json but "
                            f"its module(s) are gone — removing a wire "
                            f"family is a revision event; regenerate the "
                            f"schema deliberately"))
                summary[family] = {"status": "registered-but-absent"}
            else:
                summary[family] = {"status": "absent"}
            continue
        ext = extract_family(root, family)
        if ext is None:
            violations.append(Violation(
                rule="RA04", path=mod, line=1, col=0,
                message=f"{family}: family module or revision constant "
                        f"missing/unparseable — wire families must stay "
                        f"extractable"))
            summary[family] = {"status": "unextractable"}
            continue
        violations.extend(_hygiene(family, ext))
        if committed_families is None:
            summary[family] = {"status": "no-baseline",
                               "revision": ext["revision"]}
            continue
        entry = committed_families.get(family)
        if entry is None:
            violations.append(Violation(
                rule="RA04", path=mod, line=1, col=0,
                message=f"{family}: not in the committed wire schema; "
                        f"register it with --update-wire-schema"))
            summary[family] = {"status": "unregistered",
                               "revision": ext["revision"]}
            continue
        same_layout = entry.get("layout_sha256") == ext["layout_sha256"]
        same_rev = entry.get("revision") == ext["revision"]
        if same_layout and same_rev:
            summary[family] = {"status": "ok", "revision": ext["revision"]}
        elif not same_layout and same_rev:
            changed = sorted(
                {d["format"] for d in ext["formats"]}
                ^ {d["format"] for d in entry.get("formats", [])})
            violations.append(Violation(
                rule="RA04", path=mod, line=1, col=0,
                message=f"{family}: wire layout changed (formats "
                        f"{changed}) without a codec_revision() bump — "
                        f"bump "
                        f"{'/'.join(c for _, c in FAMILIES[family]['revision_consts'])} "
                        f"and regenerate the fingerprints "
                        f"(--update-wire-schema)"))
            summary[family] = {"status": "layout-changed-no-bump",
                               "revision": ext["revision"]}
        else:
            violations.append(Violation(
                rule="RA04", path=mod, line=1, col=0,
                message=f"{family}: revision is now {ext['revision']!r} "
                        f"(fingerprint file has {entry.get('revision')!r}) "
                        f"— stale wire_schema.json; regenerate with "
                        f"--update-wire-schema and commit it with the "
                        f"bump"))
            summary[family] = {"status": "stale-fingerprint",
                               "revision": ext["revision"]}
    return violations, summary
