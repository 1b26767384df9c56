"""Per-task distortion: price each operating point by what it does to each
head's *output*, not by tensor PSNR.

Counterpart of ``repro/tasks/distortion.py``. The sweep runs on the card
(the quantize and histogram kernels once per image and operating point, the
consolidate kernel once per operating point, the flash kernel in every
detect-head call); its cache key and the JSON it writes are the JAX
package's, byte for byte, so either package's cache serves the other.

Tensor-level PSNR (serve/rate_control.py's RD tables) treats every restored
value as equally important; a classification head that only consumes the
global average pool is far more robust to quantization than a dense
per-cell detector. Following the multi-task bit-allocation formulation
(Alvar & Bajić 2020), each operating point is swept once — encode /
decode / restore exactly as deployment runs it — and every registered head
runs over the restored tensor; the head's own divergence against its
uncompressed-tensor reference output becomes that task's distortion at that
point.

Task quality is reported in dB (``-10·log10(divergence)``, higher is
better) so the per-task tables reuse :class:`repro_torch.serve.RDPoint` —
``psnr_db`` holds the task quality, ``kl`` the raw divergence — and the
existing controller/serialization machinery applies unchanged.

The disk cache (:func:`load_or_build_task_tables`) is keyed on the ops
grid, :func:`repro_torch.serve.rate_control.codec_revision`, AND the
head-set identity + task-weight vector, so a single-task cache can never
be served to a multi-task caller (and vice versa).
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from repro_torch import pipeline
from repro_torch.core.split import check_device, cnn_fns, to_device
from repro_torch.device import resolve_device
from repro_torch.serve.rate_control import (RDPoint, codec_revision,
                                            op_to_json, rd_table_from_json,
                                            rd_table_to_json)
from repro_torch.tasks.heads import HeadConfig, get_head, run_heads

TASK_QUALITY_EPS = 1e-12


def divergence_to_db(divergence: float) -> float:
    """Map a head-output divergence (0 = identical) onto a higher-is-better
    dB scale comparable across heads: ``-10·log10(max(d, eps))``."""
    return -10.0 * math.log10(max(float(divergence), TASK_QUALITY_EPS))


def task_divergences(reference: dict, outputs: dict) -> dict:
    """{task: divergence} for every task present in both output dicts."""
    out = {}
    for task in sorted(set(reference) & set(outputs)):
        out[task] = get_head(task).divergence(reference[task], outputs[task])
    return out


def build_task_rd_tables(params, baf_bank: dict, imgs, *, head_bank: dict,
                         head_cfg: HeadConfig, ops,
                         consolidation: bool = True, device=None) -> dict:
    """Sweep ``ops`` once; price every head at every point.

    params    : the CNN (models/cnn.py), on ``device``
    baf_bank  : {c: (BaFConv, sel_idx)} — BaF predictor per C, on ``device``
    imgs      : (B, H, W, 3) calibration batch (numpy), moved to ``device``
                once
    head_bank : {task: head module} (tasks/heads.init_head_bank), on
                ``device``
    ops       : operating-point grid (e.g. serve.rate_control.rd_grid)
    device    : where the sweep runs (``None`` = the card)

    Returns {task: [RDPoint]} where each point's ``bits_per_example`` is the
    measured per-request container bits (identical across tasks — one
    stream feeds all heads) and ``psnr_db``/``kl`` hold the task's quality
    dB / raw output divergence. Each op is encoded (one image per request),
    decoded in one batch, and restored exactly once; the heads fan out from
    the single restored batch — the same one-decode-N-forwards shape the
    serving gateway runs.
    """
    dev = resolve_device(device)
    check_device(dev, params=params,
                 **{f"baf_c{c}": p for c, (p, _) in baf_bank.items()})
    edge, _ = cnn_fns(params)
    z = edge(to_device(imgs, dev))
    tasks = tuple(sorted(head_bank))
    reference = run_heads(params, head_bank, z, tasks, head_cfg)
    specs = {c: pipeline.ModelSpec(sel_idx=np.asarray(sel), params=params,
                                   baf_params=baf)
             for c, (baf, sel) in sorted(baf_bank.items())}
    n = int(np.asarray(imgs).shape[0])
    tables: dict[str, list] = {t: [] for t in tasks}
    for op in ops:
        if op.c not in specs:
            raise ValueError(f"operating point wants C={op.c} but the bank "
                             f"holds {sorted(baf_bank)}")
        plan = pipeline.compile(op, specs[op.c], consolidation=consolidation,
                                device=dev)
        # deployment granularity: one request = one example = one container
        blobs = [plan.encode(z[i:i + 1]) for i in range(n)]
        per_req_bits = float(np.mean([b.stats.wire_bits for b in blobs]))
        z_tilde = plan.restore(plan.decode_batch(blobs))
        outputs = run_heads(params, head_bank, z_tilde, tasks, head_cfg)
        for task, div in task_divergences(reference, outputs).items():
            tables[task].append(RDPoint(
                op=op, bits_per_example=per_req_bits,
                psnr_db=divergence_to_db(div), kl=float(div)))
    return tables


# ---------------------------------------------------------------------------
# Disk cache (benchmark / CI time budget)
# ---------------------------------------------------------------------------

def task_set_key(head_bank_or_names, weights: dict | None = None) -> dict:
    """JSON-serializable identity of a head set + its task-weight vector —
    the extra cache-key material multi-task sweeps must carry."""
    names = sorted(head_bank_or_names)
    w = dict(weights or {})
    return {"heads": names,
            "weights": [float(w.get(n, 1.0)) for n in names]}


def load_or_build_task_tables(cache_path, key: dict | None = None,
                              build=None, *, ops, tasks: dict) -> dict:
    """Per-task analogue of ``serve.rate_control.load_or_build_rd_table``.

    The effective cache key is ``key`` + the full ``ops`` grid +
    ``codec_revision()`` + ``tasks`` (a :func:`task_set_key` dict: head-set
    identity and weight vector). Any mismatch — including a single-task
    cache on disk where a multi-task sweep is requested — rebuilds in
    place. The committed ``benchmarks/rd_cache_tasks_*.json`` are the JAX
    benchmark's caches: read a copy of one, never the file itself.
    """
    if build is None:
        raise TypeError("load_or_build_task_tables needs a build callable")
    full_key = dict(key or {})
    full_key["ops"] = [op_to_json(p) for p in ops]
    full_key["codec_rev"] = codec_revision()
    full_key["tasks"] = dict(tasks)

    cache_path = os.fspath(cache_path)
    try:
        with open(cache_path) as f:
            data = json.load(f)
        if data.get("key") == full_key:
            return {t: rd_table_from_json(rows)
                    for t, rows in data["tables"].items()}
    except (OSError, ValueError, KeyError, AttributeError, TypeError):
        pass                         # any unusable cache file -> rebuild
    tables = build()
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": full_key,
                   "tables": {t: rd_table_to_json(rows)
                              for t, rows in sorted(tables.items())}},
                  f, indent=1)
    os.replace(tmp, cache_path)
    return tables
