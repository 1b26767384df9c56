"""Whole runs of every cell at smoke size on the CPU, the look for a card
skipped: the program comes out correct; the control (the reference in
TF32 in the program's place) and each fault the cells can have, planted
in the timed path, come out not correct, against each cell's own limits.
"""
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

from portbench import bench, control, smoke, spec
from portbench.run import main

CPU = torch.device("cpu")
CELLS = spec.cell_names()          # the benchmark's cells and the edge cell
SEED = 2**31 + 99


def _run(name, traced=False, seed=SEED):
    return bench.run(smoke.smoke_cell(name), seed, 0.1, traced, device=CPU,
                     t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in spec.metrics_for(name, False)}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_reads_host_metrics(name):
    out = _run(name, traced=True)
    assert out["correct"]
    # no device here: the device-trace readers find nothing and stay silent
    want = {m["name"] for m in spec.metrics_for(name, True)
            if m["source"] != "device_trace"}
    assert set(out["metrics"]) == want
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = smoke.smoke_cell(name)
    r = control.readings(cell, SEED, 0.1, CPU)
    assert r["program"]["verdict"]
    assert any(v > cell.limits[k] for k, v in r["control"].items())


def _planted(monkeypatch, plant):
    """``plant`` applied to the program that cnn_baf's ``build`` returns."""
    family = spec.family("cnn_baf")
    real = family.build

    def build(*args, **kwargs):
        return plant(real(*args, **kwargs))
    monkeypatch.setattr(family, "build", build)


def _half_batch(cloud):
    """Half of the batch left out, the mean of the rest in its place."""
    def broken(z):
        out = cloud(z).clone()
        half = max(1, out.shape[0] // 2)
        out[half:] = out[:half].mean(dim=0)
        return out
    return broken


def _one_answer_altered(cloud):
    calls = [0]

    def broken(z):
        out = cloud(z).clone()
        calls[0] += 1
        if calls[0] == 3:                      # in the window, not warm-up
            out[0, [0, 1]] = out[0, [1, 0]]
        return out
    return broken


FAULTS = {
    "half_batch": _half_batch,
    "answer_altered": _one_answer_altered,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", [n for n in CELLS if "edge" not in n])
def test_fault_in_the_cloud_path_is_caught(monkeypatch, name, fault):
    def plant(prog):
        if prog.gateway is not None:
            prog.gateway._cloud_fn = FAULTS[fault](prog.gateway._cloud_fn)
            return prog
        return dataclasses.replace(prog, cloud=FAULTS[fault](prog.cloud))
    _planted(monkeypatch, plant)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [n for n in CELLS if "edge" in n])
def test_code_altered_on_the_edge_is_caught(monkeypatch, name):
    def plant(prog):
        encode = prog.plan.encode

        def broken(z):
            blob = encode(z)
            data = bytearray(blob.data)
            data[-1] = (data[-1] + 1) % 256        # one code, one step
            return dataclasses.replace(blob, data=bytes(data))
        prog.plan.encode = broken
        return prog
    _planted(monkeypatch, plant)
    out = _run(name)
    assert not out["correct"]
    # a code stepped by one lies 0 to 1 bins outside its value's bin
    check = out["checks"]["code_bin_excess"]
    assert check["value"] > check["limit"]


def test_seed_fixes_the_inputs():
    cell = smoke.smoke_cell(CELLS[0])
    a = bench.Setup(cell, 2**33 + 5, CPU).inputs
    b = bench.Setup(cell, 2**33 + 5, CPU).inputs
    np.testing.assert_array_equal(a.frames_host, b.frames_host)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert [x.data for x in a.pool_blobs] == [x.data for x in b.pool_blobs]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """A short run of every benchmark cell at its full size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in spec.benchmark()["workloads"]:
        out = bench.run(bench.Cell(w["name"]), 2**31 + 17, 1.0, False,
                        device=torch.device("cuda", 0),
                        t_start=time.perf_counter())
        assert out["correct"], (w["name"], out["checks"])
        assert out["device"]["kind"] == torch.cuda.get_device_name(0)
