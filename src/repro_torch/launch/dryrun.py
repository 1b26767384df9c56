"""Multi-pod dry run: every (arch x input-shape) cell on the production
meshes, run once on meta tensors, with its per-device memory and cost.

  PYTHONPATH=src python -m repro_torch.launch.dryrun        # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod-only --json out.json

Counterpart of ``repro/launch/dryrun.py``. Where the reference lowers and
compiles each cell on 512 fake host devices, this process joins a fake
process group (backend ``"fake"``, ``torch.testing._internal.distributed.
fake_pg.FakeStore``: collectives return at once) as rank 0 of 512, builds
the production mesh over it (``launch.mesh.make_production_mesh``: (data
16, model 16), or (pod 2, data 16, model 16)), places the cell's meta
arguments as DTensors by the cell's placements (each a meta shard of rank
0's shape) and runs ``cell.fn`` once under ``analyze_program``. A cell
passes when its step runs to its end, so that every collective its
placements imply is issued. The hand-written kernels are charged from
their shapes on meta tensors (``launch.hlo_cost.charged``).

Record keys, the reference's:
  argument_size_in_bytes  the local shards of the arguments, one device
  output_size_in_bytes    the local shards of the outputs
  temp_size_in_bytes      the peak of live intermediate bytes on one
                          device: the most bytes of op outputs alive at
                          once while the step runs, as the counter sees
                          them (the outputs included, the arguments not)
  generated_code_size_in_bytes  None: eager code generates none
  flops, bytes_accessed   per device, from the local ops DTensor runs
  collective_bytes        by kind, from the c10d ops (result bytes)
  *_scaled                equal to the unscaled ones: eager code is
                          unrolled, no trip count scales anything
  compile_s               the wall seconds of the cell

The cells' parallelism is DTensor's, not the reference's: a product's
partial sums are all-reduced to ``Replicate()`` (``distributed.api.
WholeProducts``) where XLA reduce-scatters them at the ``act_hidden``
sites, the embedding table is read whole (``distributed.api.lookup``),
and MoE experts are gathered on each rank. So every record names, under
``not_comparable_with_reference``, the keys that count that program and
overstate the reference's: the temp bytes, the bytes accessed and the
collective bytes, and for MoE archs the flops. The argument and output
bytes are the placements' own and equal the reference's where every
sharded dim divides.

The reference's HLO-text parsers (``collective_bytes``, ``_OP_RE``,
``_shape_bytes``) are not ported: nothing here produces HLO text.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.hlo_cost import analyze_program
from repro_torch.launch.mesh import make_production_mesh

FAKE_WORLD = 512           # the largest production mesh: 2 x 16 x 16
# the keys that count DTensor's program, not the reference's (see above)
NOT_COMPARABLE = ("temp_size_in_bytes", "bytes_accessed", "bytes_scaled",
                  "collective_bytes", "collective_bytes_scaled")


def fake_mesh(*, multi_pod: bool, shape: dict | None = None) -> DeviceMesh:
    """The production mesh (or a mesh of ``shape``, {axis: size}) over a
    fake process group of FAKE_WORLD ranks (joined once per process, as
    rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    shape = shape or make_production_mesh(multi_pod=multi_pod).shape
    n = 1
    for size in shape.values():
        n *= size
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape.values())),
                      mesh_dim_names=tuple(shape))


def lower_cell(arch: str, shape: str, *, multi_pod: bool, smoke: bool = False,
               tcfg_overrides=None, overrides=None, cut=None,
               mesh_shape=None):
    """-> (the cell, its arguments placed as meta DTensors, meta dict).
    ``mesh_shape`` ({axis: size}) replaces the production mesh."""
    from repro_torch.launch.specs import build_cell, place
    mesh = fake_mesh(multi_pod=multi_pod, shape=mesh_shape)
    cell = build_cell(arch, shape, mesh, multi_pod=multi_pod, smoke=smoke,
                      tcfg_overrides=tcfg_overrides, overrides=overrides,
                      cut=cut)
    args = place(cell.args, cell.in_placements, mesh)
    return cell, args, {"kind": cell.kind, "mesh": dict(
        zip(mesh.mesh_dim_names, mesh.shape))}


def run_cell(arch: str, shape: str, *, multi_pod: bool, verbose=True,
             tcfg_overrides=None, overrides=None, smoke: bool = False,
             cut=None, mesh_shape=None) -> dict:
    from repro_torch.launch.specs import local_bytes
    t0 = time.time()
    rec = {"arch": arch, "shape": shape,
           "mesh": "pod2x16x16" if multi_pod else "16x16", "status": "ok"}
    if overrides:
        rec["overrides"] = overrides
    try:
        cell, args, meta = lower_cell(arch, shape, multi_pod=multi_pod,
                                      smoke=smoke,
                                      tcfg_overrides=tcfg_overrides,
                                      overrides=overrides, cut=cut,
                                      mesh_shape=mesh_shape)
        rec["mesh"] = "x".join(str(v) for v in meta["mesh"].values())
        rec["kind"] = meta["kind"]
        rec["argument_size_in_bytes"] = local_bytes(args)
        outs = []
        cost = analyze_program(lambda: outs.append(cell.fn(*args)),
                               track_peak=True)
        rec["output_size_in_bytes"] = local_bytes(outs[0])
        rec["temp_size_in_bytes"] = cost["peak_bytes"]
        rec["generated_code_size_in_bytes"] = None
        rec["flops"] = cost["flops"]
        rec["bytes_accessed"] = cost["bytes"]
        rec["collective_bytes"] = cost["collective_bytes"]
        rec["kernels"] = {}
        for k in cost["kernels"]:
            rec["kernels"][k["name"]] = rec["kernels"].get(k["name"], 0) + 1
        rec["flops_scaled"] = rec["flops"]
        rec["bytes_scaled"] = rec["bytes_accessed"]
        rec["collective_bytes_scaled"] = dict(rec["collective_bytes"])
        rec["not_comparable_with_reference"] = list(NOT_COMPARABLE) + (
            ["flops", "flops_scaled"] if cell.cfg.moe is not None else [])
        rec["compile_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=-16)
        rec["compile_s"] = round(time.time() - t0, 1)
    if verbose:
        flops = rec.get("flops")
        print(f"[{rec['mesh']}] {arch:15s} {shape:12s} {rec['status']:4s} "
              f"flops={flops:.3e}" if flops else
              f"[{rec['mesh']}] {arch:15s} {shape:12s} {rec['status']}"
              + (f"  ({rec.get('error', '')[:120]})"
                 if rec["status"] != "ok" else ""),
              flush=True)
    return rec


def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            yield arch, shape, shape in cfg.supported_shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--grad-compress-bits", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="perf levers, key=value (seq_parallel=0, "
                         "remat_policy=dots, microbatches=4, flash_decode=1)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = (int(v) if v.lstrip("-").isdigit() else
                        {"true": True, "false": False}.get(v.lower(), v))
    for bkey in ("seq_parallel", "decode_seq_shard", "flash_decode"):
        if bkey in overrides:
            overrides[bkey] = bool(overrides[bkey])
    overrides = overrides or None

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    over = ({"grad_compress_bits": args.grad_compress_bits}
            if args.grad_compress_bits else None)

    t0 = time.time()
    records = []
    n_fail = 0
    for arch, shape, supported in iter_cells():
        if args.arch and canonical(args.arch) != arch:
            continue
        if args.shape and args.shape != shape:
            continue
        if not supported:
            records.append({"arch": arch, "shape": shape, "status": "skip",
                            "reason": "full attention is O(S^2) at 500k"})
            print(f"[ ---- ] {arch:15s} {shape:12s} SKIP (quadratic attn)",
                  flush=True)
            continue
        for mp in meshes:
            rec = run_cell(arch, shape, multi_pod=mp, tcfg_overrides=over,
                           overrides=overrides)
            records.append(rec)
            n_fail += rec["status"] == "FAIL"

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.json}")
    print(f"\n{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{n_fail} failed, "
          f"{sum(r['status'] == 'skip' for r in records)} skipped "
          f"in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
