"""The port's dry run (``repro_torch.launch.dryrun``): cells on meta
DTensors over a fake process group.

* qwen2-7b's smoke ``train_4k`` on a (pod 2, data 2, model 2) mesh and
  rwkv6-3b's smoke ``decode_32k`` on (data 2, model 2) (the reference
  test's pair; DTensor's sharding propagation on a 3-axis mesh takes
  minutes for rwkv6's many small ops, so its cell runs on one pod's two
  axes) pass, and their ``argument_size_in_bytes`` equal the reference's
  ``memory_analysis()`` for the same cells compiled on 8 fake CPU devices
  with Auto axes (every sharded dim divides there).
* A train cell's per-device flops at data = 2 are half those at data = 1.
* A train cell with fewer rows a rank than microbatches runs.
* The expected collective kinds appear: FSDP all-gathers of the weights,
  reduce-scatters of their gradients, all-reduces.
* The flash and scan wrappers on meta tensors charge what they charge at
  ``PERF.md``'s shapes, and return empty meta outputs.
* The CLI runs a production cell: ``--arch qwen2-7b --shape decode_32k
  --single-pod-only --json``.

The fake process group is joined in subprocesses, never in the test
process (a default group would outlive the test).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cost)
from repro_torch.kernels.linear_scan import linear_scan, linear_scan_cost
from repro_torch.launch.hlo_cost import analyze_program

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

# (arch, shape, mesh) of the port's runs
PORT = r"""
import json
from repro_torch.launch import dryrun
cells = [("qwen2_7b", "train_4k", {"pod": 2, "data": 2, "model": 2}, None),
         ("rwkv6_3b", "decode_32k", {"data": 2, "model": 2}, None),
         ("qwen2_7b", "train_4k", {"data": 2, "model": 2}, None),
         ("qwen2_7b", "train_4k", {"data": 1, "model": 2}, None),
         ("qwen2_7b", "train_4k", {"data": 64, "model": 2},
          {"microbatches": 8})]
out = []
for arch, shape, mesh, ov in cells:
    rec = dryrun.run_cell(arch, shape, multi_pod="pod" in mesh, smoke=True,
                          mesh_shape=mesh, overrides=ov, verbose=False)
    out.append(rec)
print("JSON" + json.dumps(out))
"""

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.launch.specs import build_cell
out = []
for arch, shape, dims, names in [
        ("qwen2_7b", "train_4k", (2, 2, 2), ("pod", "data", "model")),
        ("rwkv6_3b", "decode_32k", (2, 2), ("data", "model"))]:
    mesh = jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
    cell = build_cell(arch, shape, mesh, multi_pod="pod" in names, smoke=True)
    with set_mesh(mesh):
        c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings,
                    donate_argnums=cell.donate).lower(*cell.args).compile()
    out.append(c.memory_analysis().argument_size_in_bytes)
print("JSON" + json.dumps(out))
"""


def _start(code):
    return subprocess.Popen([sys.executable, "-c", code], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT))


def _result(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def runs():
    port, ref = _start(PORT), _start(REFERENCE)
    return _result(port), _result(ref)


def test_smoke_cells_pass(runs):
    for rec in runs[0]:
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["generated_code_size_in_bytes"] is None
        assert rec["flops_scaled"] == rec["flops"] > 0
        assert rec["bytes_scaled"] == rec["bytes_accessed"] > 0
        assert rec["temp_size_in_bytes"] > 0
        assert rec["output_size_in_bytes"] > 0
        # DTensor's program, not the reference's: labelled in the record
        assert {"temp_size_in_bytes", "collective_bytes"} <= set(
            rec["not_comparable_with_reference"])


def test_argument_bytes_equal_the_references_memory_analysis(runs):
    port, ref = runs
    assert [port[0]["argument_size_in_bytes"],
            port[1]["argument_size_in_bytes"]] == ref


def test_train_flops_halve_with_the_data_axis(runs):
    two, one = runs[0][2], runs[0][3]
    assert two["flops"] * 2 == one["flops"]
    assert two["argument_size_in_bytes"] < one["argument_size_in_bytes"]


def test_cell_with_fewer_rows_a_rank_than_microbatches_runs(runs):
    """256 rows over data 64: 4 rows a rank, 8 microbatches asked (as
    arctic-480b's 8 rows a rank in 16 on two pods). The step runs
    gcd(4, 8) = 4 microbatches of a row a rank: ok, and flash launched as
    often as in the 4-microbatch cell (each layer twice a microbatch under
    full remat)."""
    rec = runs[0][4]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "64x2" and rec["argument_size_in_bytes"] > 0
    assert rec["kernels"] == runs[0][0]["kernels"]


def test_collective_kinds(runs):
    train, decode = runs[0][0], runs[0][1]
    assert {"all-gather", "reduce-scatter", "all-reduce"} \
        <= set(train["collective_bytes"])
    assert "all-gather" in decode["collective_bytes"]
    assert train["kernels"] == {"flash_attention": 16}


def test_wrappers_on_meta_charge_the_tables_shapes():
    """The shapes of PERF.md's kernel table (and ``test_torch_cost``'s
    TABLE): flash (2, 512, 28, 128) against 4 kv heads in bf16, causal;
    the scan at rwkv6's (2, 512, 40, 64), chunk 16, with a bonus."""
    bf = torch.bfloat16
    q = torch.empty((2, 512, 28, 128), dtype=bf, device="meta")
    k = v = torch.empty((2, 512, 4, 128), dtype=bf, device="meta")
    est = analyze_program(lambda: flash_attention(q, k, v))
    assert est["kernels"] == [{"name": "flash_attention",
                               "flops": 4.0 * 2 * 28 * 128 * (512 * 513 // 2),
                               "bytes": 16_777_216.0}]
    assert flash_attention_cost(q, k, v) == (est["flops"], est["bytes"])
    out = flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == bf
    qs = torch.empty((2, 512, 40, 64), dtype=bf, device="meta")
    ld = torch.empty((2, 512, 40, 64), device="meta")
    u = torch.empty((40, 64), device="meta")
    est = analyze_program(lambda: linear_scan(qs, qs, qs, ld, bonus=u,
                                              chunk=16))
    assert est["kernels"][0]["bytes"] == 38_021_120.0
    assert est["kernels"][0]["flops"] == linear_scan_cost(
        qs, qs, qs, ld, bonus=u, chunk=16)[0]
    y, state = linear_scan(qs, qs, qs, ld, bonus=u, chunk=16)
    assert y.shape == qs.shape and y.dtype == torch.float32
    assert state.shape == (2, 40, 64, 64) and state.device.type == "meta"


def test_cli_production_cell(tmp_path):
    out = tmp_path / "dry.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", "decode_32k", "--single-pod-only", "--json",
         str(out)], env=ENV, capture_output=True, text=True, timeout=600,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 ok, 0 failed, 0 skipped" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["kind"] == "decode" and rec["argument_size_in_bytes"] > 0
