"""Nothing the benchmark runs loads JAX or the JAX package ``repro``: a
fresh interpreter imports the harness, the reference, every reader, every
configuration's family and the port's modules that the cells drive, then
lists the loaded modules whose top-level name is one of them, compared
whole."""
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys
from portbench import bench, control, counts, inputs, loops, smoke, spec
from portbench import trace
from portbench.reference import model, wire
for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
for c in spec.benchmark()["configs"]:
    spec.family_of(spec.config(c["name"]))
import repro_torch.pipeline, repro_torch.models.cnn, repro_torch.core.baf
import repro_torch.serve.gateway, repro_torch.obs.hooks
import repro_torch.kernels._build
from portbench.run import forbidden_modules
print(json.dumps([forbidden_modules(), "repro_torch" in sys.modules]))
"""


def test_fresh_process_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    found, port_loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and port_loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"repro.core", "jax.numpy"} <= set(run.forbidden_modules())
