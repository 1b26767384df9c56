"""`repro_torch.analysis`: the invariant linter and replay sanitizer for
the port's tree.

Counterpart of ``repro/analysis``: the same rule ids, engine, ratchet and
wire fingerprints, with the port's scopes. The gateway's replay gates rest
on the same invariants as the reference's:

  * no wall clock on virtual-clock paths (serve/, session/, codec/,
    pipeline/, obs/, tasks/; ``obs/hooks.py`` is the allowlisted sink),
  * no unseeded legacy RNG, and no set-iteration order feeding wire bytes
    or schedules,
  * CUDA code built and loaded only in ``kernels/_build.py`` (RA03),
  * no host sync (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``np.asarray``) inside a ``torch.compile`` or CUDA-graph region (RA05),
  * no wire-layout change without a :func:`repro_torch.serve.codec_revision`
    bump: the BaF2/RTC1/SSF1 fingerprints hash no paths, so the port's
    committed ``wire_schema.json`` equals the reference's.

``python -m repro_torch.analysis --check`` runs the AST pass (stdlib only)
over ``src/repro_torch/``, ``tools/``, ``chip_smoke.py`` and the port's
tests (``tests/test_torch_*.py``, ``tests/torch_ranks.py``), gates against
``src/repro_torch/analysis/baseline.json`` (empty) and verifies
``wire_schema.json``.

Suppressions are inline pragmas with a mandatory reason, under the port's
own prefix::

    t0 = time.perf_counter()  # repro_torch: allow[RA01] -- why

The reference's pattern does not match that prefix, and this one does not
match ``repro:``, so neither linter sees the other's pragmas (a ``repro:``
pragma in a port file would be an unused suppression, RA00, to the
reference's linter, which walks all of ``src/``).

Layout:

  * :mod:`repro_torch.analysis.rules`     — the rule registry + config
  * :mod:`repro_torch.analysis.engine`    — discovery, pragmas, ratchet
  * :mod:`repro_torch.analysis.wire`      — RA04 wire-schema fingerprints
  * :mod:`repro_torch.analysis.fixes`     — the ``--fix`` autofixer
  * :mod:`repro_torch.analysis.sanitizer` — the runtime replay sanitizer
"""
from __future__ import annotations

from repro_torch.analysis.engine import (AnalysisResult, Violation, load_baseline,
                                   run_analysis, write_baseline)
from repro_torch.analysis.rules import CONFIG, RULES, config_fingerprint
from repro_torch.analysis.sanitizer import ReplaySanitizerError, replay_sanitizer

__all__ = [
    "AnalysisResult", "Violation", "run_analysis",
    "load_baseline", "write_baseline",
    "CONFIG", "RULES", "config_fingerprint",
    "ReplaySanitizerError", "replay_sanitizer",
]
