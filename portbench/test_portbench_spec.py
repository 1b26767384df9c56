"""BENCHMARK.json against the benchmark's contract, and the harness's data
files against it: every cell's configuration, family, traffic mix and
limits, every metric's reader, each family's own checks of its
configurations, and the CNN's counts against numbers worked by hand."""
import copy
import json
import re

import pytest

from portbench import counts, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CNN_BAF = spec.family("cnn_baf")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"requests_per_s", "wire_bytes_per_request", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric["workloads"]) <= set(CELLS)
    for cell in metric["workloads"]:     # each listed cell reports `moves`
        assert metric["moves"] in [m["name"]
                                   for m in spec.metrics_for(cell, False)]
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_cell_names_known_parts(name):
    w = spec.workload(name)
    assert w["chips"] == 1
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    c = spec.cell(name)
    assert (c["config"], c["traffic"]) == (w["config"], w["traffic"])
    reported = [m["name"] for m in spec.metrics_for(name, False)]
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.metrics_for(name, True)


@pytest.mark.parametrize("name", spec.cell_names())
def test_cell_file(name):
    c = spec.cell(name)
    cfg = spec.config(c["config"])
    assert cfg["name"] == c["config"]
    assert spec.traffic(c["traffic"])["kind"] in spec.family_of(cfg).KINDS
    assert set(c["limits"]) == set(c["readings"])
    assert all(0 < v for v in c["limits"].values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = spec.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert set(entry["reduced"]) <= set(cfg)
    assert cfg["reduced"] == entry["reduced"]
    assert callable(spec.family_of(cfg).check_config)


def test_counts_worked_by_hand():
    c64 = spec.config("yolo3-baf-c64")
    # stem + split: 226,492,416 + 6 x 1,207,959,552 + 3 x 134,217,728 MACs
    assert CNN_BAF.edge_flops(c64) == 2 * (226_492_416 + 6 * 1_207_959_552
                                           + 3 * 134_217_728)
    assert round(CNN_BAF.edge_flops(c64) / 1e9, 1) == 15.8
    assert counts.quantize_bytes(1, 4096, 64, 8) == 1_311_232
    assert counts.consolidate_bytes(8, 4096, 64, 8) == 18_876_672
    # BaF: the x2 transposed conv's 4096 x 64 x 64 x 9 products, two 64->64
    # and one 64->128 3x3 convs at 128x128, the split conv at 64x64
    assert CNN_BAF.restore_flops(c64) == 2 * (150_994_944 + 2 * 603_979_776
                                              + 2 * 1_207_959_552)
    assert CNN_BAF.cloud_flops(c64) == 2 * (2 * (134_217_728
                                                 + 1_207_959_552)
                                            + 256 * 80)
    assert CNN_BAF.request_flops(c64, "gateway_serve") == sum(
        c64["counts"][k] for k in ("edge_flops", "restore_flops",
                                   "cloud_flops"))


CNN_BAF_CONFIGS = [c["name"] for c in BENCH["configs"]
                   if spec.config(c["name"])["family"] == "cnn_baf"]


@pytest.mark.parametrize("name", CNN_BAF_CONFIGS)
def test_weights_fit_the_ports_modules(name):
    """cnn_baf's own checks of each of its configurations: the paper's
    split shape and Q, the counts as the family works them out, and
    weights that fit the port's CNN and BaF modules key for key."""
    CNN_BAF.check_config(spec.config(name))


BAD_CNN_BAF = {
    "split_shape": lambda cfg: cfg.update(split_shape=[64, 64, 128]),
    "split_q": lambda cfg: cfg.update(split_q=64),
    "counts": lambda cfg: cfg["counts"].update(edge_flops=1),
    # the layer table's split conv narrowed, where the port's CNN is not
    "weights": lambda cfg: cfg["split"].__setitem__(1, 128),
}


@pytest.mark.parametrize("fault", sorted(BAD_CNN_BAF))
def test_cnn_baf_check_config_refuses(fault):
    cfg = copy.deepcopy(spec.config("yolo3-baf-c64"))
    BAD_CNN_BAF[fault](cfg)
    if fault == "weights":
        cfg["counts"] = CNN_BAF.all_counts(cfg)
    with pytest.raises(ValueError, match=fault):
        CNN_BAF.check_config(cfg)
