"""Guards on the port's boundaries.

* Every module of ``repro_torch`` imports with ``jax``, ``jaxlib`` and
  ``repro`` refused by an import hook, in a fresh interpreter.
* ``chip_smoke.py`` imports none of them either, and without a card it
  exits non-zero and prints no result, in the repo and alone in a folder.
* ``device=None`` means the card: where there is none, the entry points
  raise instead of running on the CPU.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in one test process)
import numpy as np
import pytest
import torch

from repro_torch import pipeline, serve
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConv, BaFConvConfig
from repro_torch.core.split import SplitInferenceEngine, fidelity_metrics
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "repro")

_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(json.dumps({"modules": names, "leaked": leaked}))
""" % (BLOCKED, BLOCKED)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_nothing_of_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for name in ("repro_torch.kernels.quantize", "repro_torch.codec.rans",
                 "repro_torch.pipeline.plan", "repro_torch.bridge",
                 "repro_torch.serve.gateway", "repro_torch.obs.trace",
                 "repro_torch.launch.gateway_demo"):
        assert name in res["modules"]


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots.isdisjoint(BLOCKED), sorted(roots)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the smoke test would run for real")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=script.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
        return
    cfg = smoke_config()._replace(input_size=32)
    calls = [
        lambda: resolve_device(None),
        lambda: CNN(cfg),
        lambda: BaFConv(BaFConvConfig(c=8, q=cfg.split_q, hidden=8)),
        lambda: pipeline.compile(pipeline.OperatingPoint(c=8, bits=8),
                                 pipeline.ModelSpec(sel_idx=list(range(8)))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = CNN(cfg, device="cpu")
    baf = BaFConv(BaFConvConfig(c=8, q=cfg.split_q, hidden=8), device="cpu")
    bank = {8: (baf, list(range(8)))}
    img = np.zeros((1, 32, 32, 3), np.float32)
    for call in [
        lambda: SplitInferenceEngine(model, baf, list(range(8))),
        lambda: serve.ServingGateway(model, bank),
        lambda: serve.MultiTenantGateway(model, bank,
                                         tenants=[serve.TenantSpec("a")]),
        lambda: serve.build_rd_table(model, bank, img),
        lambda: fidelity_metrics(model, baf, list(range(8)), img, bits=8),
    ]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
