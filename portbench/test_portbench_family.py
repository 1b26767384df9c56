"""A model family is only files: a toy family module, configuration,
traffic mix, cell and BENCHMARK.json, written into a folder of the test's
own that the finder searches first, run through ``bench.run`` on the CPU
with no edit to the harness. The toy is a seeded linear map whose answers
are logits; its control (the reference in TF32) and a fault planted in
its program have to fail the cell's limit. A configuration with no family
or an unknown one, and a traffic kind its family does not list, raise."""
import json
import time

import pytest
import torch

from portbench import bench, control, smoke, spec

CPU = torch.device("cpu")
SEED = 2**31 + 4099
CELL = "toy-map-b4"

TOY_FAMILY = '''"""A toy family: one seeded linear map, logits = x @ w."""
import math
import time
from types import SimpleNamespace

import numpy as np

from portbench import inputs, loops
from portbench.reference.model import to_tf32

KINDS = ("toy_closed_loop",)
PRODUCT_PEAK = "float32_product_flops_per_s"


def make_inputs(cfg, traffic, seed, device):
    gen = inputs.generator(seed, device)
    d_in, d_out = cfg["d_in"], cfg["d_out"]
    w = inputs.make_weights([("w", (d_in, d_out), "n", d_in ** -0.5),
                             ("x", (traffic["pool"], d_in), "n", 1.0)],
                            gen, device)
    return SimpleNamespace(w=w["w"], x=w["x"],
                           schedule=inputs.Schedule(seed, traffic["pool"]))


def build(cfg, traffic, inp, device):
    w = inp.w.clone()
    return lambda x: x @ w


def clients(kind, prog, traffic, inp, device):
    return None


def window(kind, prog, traffic, inp, seconds, span, device):
    def serve(rows):
        with span("map"):
            out = prog(inp.x[rows]).cpu().numpy()
        return time.perf_counter(), list(out), [4 * inp.x.shape[1]] * len(rows)
    return loops.closed_loop(traffic["outstanding"], traffic["batch"],
                             seconds, serve,
                             lambda i: int(inp.schedule.frame[i]))


def reference(kind, cfg, inp, device, tf32=False):
    x, w = inp.x.cpu(), inp.w.cpu()
    if tf32:
        x, w = to_tf32(x), to_tf32(w)
    return x.numpy() @ w.numpy()


def numbers(kind, cfg, inp, device, frames, answers, want, *,
            control=False):
    if control:
        got = reference(kind, cfg, inp, device, tf32=True)
        frames, answers = list(range(len(got))), list(got)
    if not answers:
        return {"logit_gap": math.inf}
    got = np.stack(answers).astype(np.float64)
    ref = want[np.asarray(frames)].astype(np.float64)
    gap = np.abs(got - ref).max(axis=1) / np.abs(ref).max(axis=1)
    return {"logit_gap": float(gap.max())}


def smoke(cfg, traffic):
    return cfg, traffic


def request_flops(cfg, kind):
    return 2 * cfg["d_in"] * cfg["d_out"]


def check_config(cfg):
    if min(cfg["d_in"], cfg["d_out"]) < 1:
        raise ValueError(f"{cfg['name']}: empty map")
'''


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files under ``tmp_path``, searched before the harness's
    own folder; readers and peaks still come from the harness."""
    real = spec.benchmark()
    e2e = [dict(m, workloads=[CELL]) for m in real["end_to_end"]
           if m["name"] in ("requests_per_s", "wire_bytes_per_request",
                            "setup_s")]
    per_layer = [dict(m, workloads=[CELL]) for m in real["per_layer"]
                 if m["name"] in ("baf_mfu", "request_p95_ms")]
    _write(tmp_path / "BENCHMARK.json", {
        **real, "configs": [{"name": "toy-map", "reduced": []}],
        "workloads": [{"name": CELL, "config": "toy-map",
                       "traffic": "toy_b4", "chips": 1}],
        "end_to_end": e2e, "per_layer": per_layer})
    _write(tmp_path / "families" / "toy.py", TOY_FAMILY)
    _write(tmp_path / "configs" / "toy-map.json",
           {"name": "toy-map", "family": "toy", "d_in": 64, "d_out": 16,
            "reduced": []})
    _write(tmp_path / "traffic" / "toy_b4.json",
           {"kind": "toy_closed_loop", "pool": 32, "outstanding": 8,
            "batch": 4})
    _write(tmp_path / "cells" / f"{CELL}.json",
           {"config": "toy-map", "traffic": "toy_b4",
            "limits": {"logit_gap": 1e-5},
            "readings": {"logit_gap": "float32 rounding against TF32's"}})
    monkeypatch.setattr(spec, "DIRS", [tmp_path, *spec.DIRS])
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")
    return tmp_path


def _run(traced=False):
    return bench.run(smoke.smoke_cell(CELL), SEED, 0.1, traced, device=CPU,
                     t_start=time.perf_counter())


def test_a_new_family_runs_correct_from_files_alone(toy):
    assert CELL in spec.cell_names()
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"requests_per_s", "wire_bytes_per_request",
                                   "setup_s"}
    assert out["metrics"]["wire_bytes_per_request"]["value"] == 4 * 64
    assert out["checks"]["logit_gap"]["limit"] == 1e-5


def test_the_family_counts_the_products(toy):
    """``baf_mfu`` reads a request's products and the peak's name from the
    cell's family."""
    out = _run(traced=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"baf_mfu", "request_p95_ms"}
    assert out["metrics"]["baf_mfu"]["value"] > 0
    cell = bench.Cell(CELL)
    assert cell.family.request_flops(cell.cfg, cell.kind) == 2 * 64 * 16


def test_the_toy_control_fails_its_limit(toy):
    cell = smoke.smoke_cell(CELL)
    r = control.readings(cell, SEED, 0.1, CPU)
    assert r["program"]["verdict"]
    assert r["control"]["logit_gap"] > cell.limits["logit_gap"]


def _one_answer_altered(prog):
    calls = [0]

    def broken(x):
        out = prog(x).clone()
        calls[0] += 1
        if calls[0] == 3:                      # in the window, not warm-up
            out[0, [0, 1]] = out[0, [1, 0]]
        return out
    return broken


def _half_batch(prog):
    def broken(x):
        out = prog(x).clone()
        half = max(1, out.shape[0] // 2)
        out[half:] = out[:half].mean(dim=0)
        return out
    return broken


@pytest.mark.parametrize("fault", [_one_answer_altered, _half_batch],
                         ids=["answer_altered", "half_batch"])
def test_a_fault_in_the_toy_program_is_caught(toy, monkeypatch, fault):
    family = spec.family("toy")
    real = family.build
    monkeypatch.setattr(family, "build",
                        lambda *a, **k: fault(real(*a, **k)))
    assert not _run()["correct"]


@pytest.mark.parametrize("family", [None, "no_such_family"])
def test_a_config_must_name_a_known_family(toy, family):
    cfg = {"name": "toy-map", "d_in": 4, "d_out": 4, "reduced": []}
    if family:
        cfg["family"] = family
    _write(toy / "configs" / "toy-map.json", cfg)
    with pytest.raises(ValueError, match="toy-map.json"):
        spec.config("toy-map")
    with pytest.raises(ValueError):
        spec.family_of(cfg)


def test_a_kind_outside_the_family_raises(toy):
    c = spec.cell(CELL)
    with pytest.raises(ValueError, match="cloud_closed_loop"):
        bench.Cell(CELL, cfg=spec.config(c["config"]),
                   traffic=dict(spec.traffic(c["traffic"]),
                                kind="cloud_closed_loop"),
                   limits=c["limits"])
