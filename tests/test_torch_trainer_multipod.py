"""The port's multi-pod training step (``make_train_step(...,
multi_pod=True)`` with ``grad_compress_bits=8``) against the reference's
own multi-pod step.

Two gloo ranks on the CPU, a pod each, run qwen2-7b's and zamba2-1.2b's
smoke configs in float32 with 1 and 2 microbatches for 3 steps on the
weights of the JAX package (``bridge.master_from_jax``). The reference's
``make_train_step(cfg, tcfg, mesh=mesh, multi_pod=True)`` runs jitted on a
(pod 2, data 2, model 2) mesh of 8 fake CPU devices with Auto axes, in a
subprocess, on the same global batches (each pod takes its contiguous
half). Step 1's loss comes before any update and agrees within 1e-4
relative; steps 2 and 3 within 1e-3, because the pods' partial gradients
are summed in another order and a gradient code can flip by one, which
Adam turns into a whole step. Both ranks hold bit-identical weights after
every run.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.lm import init_lm as jax_init_lm
from repro_torch import configs
from repro_torch.bridge import master_from_jax
from repro_torch.train.trainer import TrainConfig, make_train_step

import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2_7b", "zamba2_1p2b")
MBS = (1, 2)
B, S, STEPS = 8, 32, 3

JAX_RUN = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.models.lm import init_lm
from repro.train import trainer as jt
data = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
out = {}
for arch in %r:
    cfg = get_smoke_config(arch).with_(dtype=jnp.float32)
    for mb in %r:
        tc = jt.TrainConfig(num_microbatches=mb, grad_compress_bits=8,
                            peak_lr=1e-2, warmup_steps=0, total_steps=10)
        state = jt.init_train_state(init_lm(jax.random.PRNGKey(1), cfg), tc)
        step = jax.jit(jt.make_train_step(cfg, tc, mesh=mesh,
                                          multi_pod=True))
        losses = []
        with set_mesh(mesh):
            for i in range(%d):
                batch = {k: jnp.asarray(data[f"{arch}/{i}/{k}"])
                         for k in ("tokens", "labels")}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
        out[f"{arch}/{mb}"] = losses
print(json.dumps(out))
""" % (ARCHS, MBS, STEPS)


def _batches(arch):
    vocab = jax_smoke_config(arch).vocab
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
    batches = {arch: _batches(arch) for arch in ARCHS}
    np.savez(tmp / "batches.npz", **{
        f"{arch}/{i}/{k}": v for arch in ARCHS
        for i, b in enumerate(batches[arch]) for k, v in b.items()})
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.Popen([sys.executable, "-c", JAX_RUN,
                            str(tmp / "batches.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    masters = {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype=jax.numpy.float32)
        params = jax.tree.map(np.asarray,
                              jax_init_lm(jax.random.PRNGKey(1), jcfg))
        cfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
        masters[arch] = {k: v.detach() for k, v in master_from_jax(
            params, cfg, device="cpu").items()}
    torch.save(masters, tmp / "masters.pt")
    todo = [(arch, mb, batches[arch]) for arch in ARCHS for mb in MBS]
    ranks = torch_ranks.spawn(torch_ranks.multipod_rank, 2, (2, 1, 1), tmp,
                              todo, str(tmp / "masters.pt"))
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    want = json.loads(out.strip().splitlines()[-1])
    return {(arch, mb): (want[f"{arch}/{mb}"], [r[i] for r in ranks])
            for i, (arch, mb, _) in enumerate(todo)}


@pytest.mark.parametrize("mb", MBS)
@pytest.mark.parametrize("arch", ARCHS)
def test_multi_pod_step_matches_jax(runs, arch, mb):
    want, ranks = runs[arch, mb]
    for r in ranks:
        got = r["losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    a, b = ranks
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    # the residuals are each pod's own, and fed back
    assert a["ef"].keys() == a["params"].keys()
    assert any(float(v.abs().max()) > 0 for v in a["ef"].values())


def test_multi_pod_step_needs_the_mesh():
    cfg = configs.get_smoke_config("qwen2_7b")
    with pytest.raises(ValueError, match="needs the mesh"):
        make_train_step(cfg, TrainConfig(grad_compress_bits=8),
                        multi_pod=True)
    # without multi_pod the field is ignored, as in the reference
    make_train_step(cfg, TrainConfig(grad_compress_bits=8))
