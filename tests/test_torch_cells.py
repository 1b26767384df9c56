"""The cells of ``repro_torch.launch.specs`` on gloo ranks: DTensor
weights, batch and caches placed by the cells' placements on a
``DeviceMesh``, the models' ``shard_hidden`` calls, the flash and scan
wrappers on local shards. Each cell's loss, gradients, logits and caches
are held at 1e-4 in float32 against the reference's cell
(``repro.launch.specs.build_cell``) on the same mesh shape, jitted with
its shardings on 8 fake CPU devices with Auto axes in a subprocess (the
default Explicit axes fail there), on the same weights (JAX ``init_lm`` /
``init_encdec`` carried across by ``bridge.master_from_jax``) and numpy
inputs. A second witness: the same steps built without a cell
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``,
``make_long_ingest``) in one process, every output at 1e-4.

Meshes: (data 2, model 2) over 4 ranks (a train cell among them with 2
rows a rank in 4 microbatches, fewer rows a rank than microbatches, as
arctic-480b's and qwen2-72b's ``train_4k`` on two pods), (data 1, model
2) over 2, (data 1, model 4) over 4 (a sequence-sharded KV cache, decoded with and without
the flash-decode), and (pod 2, data 1, model 2) over 4 for a multi-pod
cell. The archs: qwen2-7b
(GQA kv heads), rwkv6-3b (the scan, chunk 16), olmoe-1b-7b (MoE rows
routed on their rank; also 2 rows a rank in 4 microbatches), zamba2-1.2b (the scan at chunk 128 and the shared
block) and whisper-tiny (the encoder-decoder).

Also: ``shard_hidden`` with no context leaves a forward bit-identical, and
the flash and scan wrappers on DTensors equal the plain versions on the
gathered tensors (including kv heads that the model axis does not
divide).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.lm import init_lm as jax_init_lm

from repro_torch.distributed import api
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.linear_scan import linear_scan_plain

from repro_torch.bridge import master_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs
from repro_torch.models.encdec import init_encdec
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                      make_prefill_step)
from repro_torch.train.trainer import make_train_step

import torch_ranks

TRAIN = dict(seq_len=16, global_batch=4, kind="train")
PREFILL = dict(seq_len=16, global_batch=4, kind="prefill")
DECODE = dict(seq_len=16, global_batch=4, kind="decode")
LONG = dict(seq_len=32, global_batch=2, kind="long")
MB2 = {"microbatches": 2}

CASES_4 = [
    ("qwen2_7b", "train_4k", TRAIN, MB2),
    # 2 rows a rank, 4 microbatches: fewer rows a rank than microbatches
    ("qwen2_7b", "train_4k", TRAIN, {"microbatches": 4}),
    ("qwen2_7b", "prefill_32k", PREFILL, None),
    ("qwen2_7b", "decode_32k", DECODE, None),
    ("rwkv6_3b", "long_500k", LONG, None),
    ("rwkv6_3b", "decode_32k", DECODE, None),
    ("olmoe_1b_7b", "train_4k", TRAIN, MB2),
    # the same for MoE: each row is a routing group, so its capacity and
    # balance loss do not depend on how rows form microbatches
    ("olmoe_1b_7b", "train_4k", TRAIN, {"microbatches": 4}),
    ("olmoe_1b_7b", "decode_32k", DECODE, None),
    ("zamba2_1p2b", "long_500k", LONG, None),
    ("whisper_tiny", "decode_32k", DECODE, None),
]
CASES_2 = [
    ("zamba2_1p2b", "train_4k", TRAIN, MB2),
    ("whisper_tiny", "train_4k", TRAIN, MB2),
]
# model 4 does not divide qwen2's 2 kv heads: the cache is sequence-sharded
CASES_SEQ = [
    ("qwen2_7b", "decode_32k", DECODE, {"flash_decode": True}),
    ("qwen2_7b", "decode_32k", DECODE, None),
]
CASES_POD = [("qwen2_7b", "prefill_32k", PREFILL, None)]
SEED = 3
TOL = 1e-4
# each group of cases: its key, the port's (pod, data, model) mesh, the
# reference's mesh (axis sizes and names)
GROUPS = [(4, (1, 2, 2), CASES_4, (2, 2), ("data", "model")),
          (2, (1, 1, 2), CASES_2, (1, 2), ("data", "model")),
          ("seq", (1, 1, 4), CASES_SEQ, (1, 4), ("data", "model")),
          ("pod", (2, 1, 2), CASES_POD, (2, 1, 2), ("pod", "data", "model"))]

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

# argv: a pickle of [(mesh sizes, names, [(arch, shape name, shape,
# overrides, params, inputs)])] -> a pickle of the outputs per case, with
# NamedTuples as dicts of their fields and arrays as numpy
REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.configs.base import SHAPES
from repro.launch import specs
from repro.models.encdec import init_encdec_cache
from repro.models.lm import init_decode_cache
from repro.train.trainer import TrainConfig, init_train_state


def f32_smoke(arch):
    return get_smoke_config(arch).with_(dtype=jnp.float32)


def plain(tree):
    if hasattr(tree, "_asdict"):
        return {k: plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return None if tree is None else np.asarray(tree)


specs.get_smoke_config = f32_smoke
with open(sys.argv[1], "rb") as f:
    groups = pickle.load(f)
out = []
for dims, names, cases in groups:
    mesh = jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims),
                         devices=jax.devices()[:int(np.prod(dims))])
    res = []
    for arch, shape_name, shape, ov, params, inputs in cases:
        specs.SHAPES = dict(SHAPES, **{shape_name: shape})     # the cut
        cell = specs.build_cell(arch, shape_name, mesh, smoke=True,
                                multi_pod="pod" in names, overrides=ov)
        cfg = f32_smoke(arch)
        params = jax.tree.map(jnp.asarray, params)
        if cell.kind == "train":
            tcfg = TrainConfig(num_microbatches=ov["microbatches"])
            batch = {k: jnp.asarray(inputs[k]).astype(v.dtype)
                     for k, v in cell.args[1].items()}
            args = (init_train_state(params, tcfg), batch)
        elif cell.kind == "prefill":
            args = (params, {k: jnp.asarray(inputs[k]).astype(v.dtype)
                             for k, v in cell.args[1].items()})
        elif cell.kind == "long":
            args = (params, jnp.asarray(inputs["tokens"]))
        else:
            b = shape["global_batch"]
            if cfg.family == "audio":
                cache = init_encdec_cache(params, cfg,
                                          jnp.asarray(inputs["enc"]),
                                          shape["seq_len"])
            else:
                cache = init_decode_cache(cfg, b, shape["seq_len"])
            args = (params, cache, jnp.asarray(inputs["token"]))
        with set_mesh(mesh):
            got = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                          out_shardings=cell.out_shardings)(*args)
        res.append(plain(got))
    out.append(res)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


class _Mesh:
    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def _one_cell(arch, shape_name, shape, overrides):
    """The case's cell on a (data 1, model 1) mesh."""
    cfg = get_smoke_config(arch).with_(dtype=torch.float32)
    return specs.build_cell(arch, shape_name, _Mesh({"data": 1, "model": 1}),
                            multi_pod=False, overrides=overrides,
                            cut=(cfg, shape))


def _randomize(params, rng):
    """Random norm scales, biases and token-shift mixes, so that a shard
    of each reaches the outputs."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "bq", "bk", "bv"):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if name in ("mu_x", "mu_base", "cm_mu_k", "cm_mu_r"):
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        return a
    return walk(params)


def _system(arch, shape_name, shape, overrides):
    """(JAX params as numpy, numpy inputs) of a case: the reference's
    initialiser at ``SEED``, then ``_randomize``; tokens, embeddings and
    whisper's encoder output drawn with numpy."""
    jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
    init = jax_init_encdec if jcfg.family == "audio" else jax_init_lm
    params = _randomize(jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(SEED), jcfg)),
        np.random.default_rng(SEED))
    cell = _one_cell(arch, shape_name, shape, overrides)
    rng = np.random.default_rng(SEED + 1)

    def draw(t):
        if t.dtype == torch.int32:
            return rng.integers(0, jcfg.vocab, tuple(t.shape)).astype(np.int32)
        return rng.normal(size=tuple(t.shape)).astype(np.float32)
    if cell.kind in ("train", "prefill"):
        inputs = {k: draw(v) for k, v in cell.args[1].items()}
    elif cell.kind == "long":
        inputs = {"tokens": draw(cell.args[1])}
    else:
        inputs = {"token": draw(cell.args[2])}
        if jcfg.family == "audio":
            inputs["enc"] = draw(torch.empty(
                (shape["global_batch"], jcfg.encdec.enc_len_decode,
                 jcfg.d_model), device="meta"))
    return params, inputs


def _unsharded(case, system):
    """The step built without a cell, on the cell's arguments."""
    cell = _one_cell(*case)
    args = torch_ranks.cell_args(cell, *system)
    cfg = cell.cfg
    if cell.kind == "train":
        return make_train_step(cfg, cell.tcfg)(*args)
    init = init_encdec if cfg.family == "audio" else init_lm
    model = init(cfg, device="cpu")
    model.load_state_dict(args[0])
    if cell.kind == "prefill":
        return make_prefill_step(cfg)(model, args[1])
    if cell.kind == "decode":
        return make_decode_step(cfg)(model, args[1], args[2])
    block = (min(specs.LONG_BLOCK, case[2]["seq_len"])
             if cfg.family == "ssm" else cfg.hybrid.attn_window_long)
    return make_long_ingest(cfg, block=block)(model, args[1])


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    return out


def _close(got, want, case):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), case
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, case
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=str(case))


def _as_reference(tree):
    """A port cache or state in the reference's layout: a NamedTuple as
    the dict of its fields, a list a layer (or a segment) stacked on a new
    leading axis, tensors and ints as numpy."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _as_reference(v) for k, v in tree._asdict().items()}
    if isinstance(tree, list):
        items = [_as_reference(v) for v in tree]
        if isinstance(items[0], dict):
            return {k: np.stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree if tree is None else np.asarray(tree)


def _tree_close(got, want, case, where=""):
    """Every array of the reference's tree ``want`` against the port's at
    the same place (fields the reference lacks are not read)."""
    if want is None:
        return
    if isinstance(want, dict):
        for k, v in want.items():
            _tree_close(got[k], v, case, f"{where}.{k}")
        return
    assert got.shape == want.shape, (case, where, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=TOL, atol=TOL,
                               err_msg=f"{case} {where}")


def _reference_close(got, want, case):
    """The port's gathered outputs against the reference cell's: a train
    step's metrics and updated weights at 1e-4, its first moments (0.1 x
    the gradients) at 1e-4 of each leaf's largest entry, as the gradient
    tests hold gradients; a serving step's logits, and its caches or
    states in the reference's layout, at 1e-4."""
    cfg = _one_cell(*case).cfg
    if isinstance(got, torch.Tensor):
        return _tree_close(_as_reference(got), want, case, "logits")
    if isinstance(got[0], torch.Tensor):
        _tree_close(_as_reference(got[0]), want[0], case, "logits")
        return _tree_close(_as_reference(got[1]), want[1], case, "cache")
    state, metrics = got
    for k in ("loss", "grad_norm", "lr"):
        _tree_close(_as_reference(metrics[k]), want[1][k], case, k)
    assert int(state.step) == int(want[0]["step"]), case
    for name, ours, theirs in (("params", state.params, want[0]["params"]),
                               ("mu", state.opt.mu, want[0]["opt"]["mu"])):
        theirs = master_from_jax(theirs, cfg, device="cpu")
        assert ours.keys() == theirs.keys(), case
        for k, w in theirs.items():
            w = w.detach()
            atol = TOL * (max(float(w.abs().max()), 1e-6) if name == "mu"
                          else 1.0)
            torch.testing.assert_close(ours[k].detach(), w, rtol=TOL,
                                       atol=atol, msg=f"{case} {name} {k}")


@pytest.fixture(scope="module")
def systems():
    return {key: [_system(*case) for case in cases]
            for key, _, cases, _, _ in GROUPS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, systems):
    """The port's cells on gloo ranks, while the reference's run in a
    subprocess."""
    tmp = tmp_path_factory.mktemp("cells")
    with open(tmp / "reference_in.pkl", "wb") as f:
        pickle.dump([(dims, names, [case + system for case, system in
                                    zip(cases, systems[key])])
                     for key, _, cases, dims, names in GROUPS], f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "reference_in.pkl"),
         str(tmp / "reference_out.pkl")], env=ENV, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {key: torch_ranks.spawn(torch_ranks.cells_rank,
                                      int(np.prod(shape)), shape, tmp,
                                      cases, systems[key])
               for key, shape, cases, _, _ in GROUPS}
        out["wrappers"] = torch_ranks.spawn(torch_ranks.wrappers_rank, 4,
                                            (1, 2, 2), tmp, _wrapper_cases())
    finally:
        _, err = ref.communicate(timeout=900)
    assert ref.returncode == 0, err[-4000:]
    with open(tmp / "reference_out.pkl", "rb") as f:
        reference = pickle.load(f)
    out["reference"] = {key: res for (key, *_), res in zip(GROUPS, reference)}
    return out


def _ids(cases):
    return [f"{a}-{s}" + ("-flash" if o and o.get("flash_decode") else "")
            + (f"-mb{o['microbatches']}"
               if o and o.get("microbatches", 2) != 2 else "")
            for a, s, _, o in cases]


def _check(ranks, systems, key, cases, i):
    case = cases[i]
    want = _unsharded(case, systems[key][i])
    for got in ranks[key]:         # every rank gathers the same outputs
        _reference_close(got[i], ranks["reference"][key][i], case)
        _close(got[i], want, case)


@pytest.mark.parametrize("i", range(len(CASES_4)), ids=_ids(CASES_4))
def test_cell_on_4_ranks(ranks, systems, i):
    _check(ranks, systems, 4, CASES_4, i)


@pytest.mark.parametrize("i", range(len(CASES_2)), ids=_ids(CASES_2))
def test_cell_on_2_ranks(ranks, systems, i):
    _check(ranks, systems, 2, CASES_2, i)


@pytest.mark.parametrize("i", range(len(CASES_SEQ)), ids=_ids(CASES_SEQ))
def test_seq_sharded_cache_cell(ranks, systems, i):
    _check(ranks, systems, "seq", CASES_SEQ, i)


@pytest.mark.parametrize("i", range(len(CASES_POD)), ids=_ids(CASES_POD))
def test_multi_pod_cell(ranks, systems, i):
    _check(ranks, systems, "pod", CASES_POD, i)


def _wrapper_cases():
    """flash: 4 heads on 2 kv heads (both split over model 2) and 6 heads
    on 3 (the kv heads do not split: repeated first); the scan with a
    bonus and an initial state."""
    rng = np.random.default_rng(9)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    flash = [(a(2, 8, 4, 16), a(2, 8, 2, 16), a(2, 8, 2, 16)),
             (a(2, 8, 6, 16), a(2, 8, 3, 16), a(2, 8, 3, 16))]
    scan = [(a(2, 8, 4, 8), a(2, 8, 4, 8), a(2, 8, 4, 8),
             -np.abs(a(2, 8, 4, 8)), a(4, 8), a(2, 4, 8, 8))]
    return flash, scan


def test_wrappers_on_dtensors_equal_the_plain_versions(ranks):
    flash, scan = _wrapper_cases()
    for res in ranks["wrappers"]:
        for (q, k, v), got in zip(flash, res["flash"]):
            want = flash_attention_plain(*(torch.from_numpy(t)
                                           for t in (q, k, v)))
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for case, (y, st) in zip(scan, res["scan"]):
            q, k, v, ld, u, s0 = (torch.from_numpy(t) for t in case)
            wy, wst = linear_scan_plain(q, k, v, ld, bonus=u,
                                        initial_state=s0, chunk=4)
            torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(st, wst, rtol=1e-5, atol=1e-5)


def test_shard_hidden_is_a_no_op_outside_a_cell():
    """Without a context, and on a plain tensor inside one, ``shard_hidden``
    returns its input: every forward outside a cell is the one it was."""
    x = torch.randn(2, 3, 4)
    assert api.shard_hidden(x, "batch", None, "act_hidden") is x
    with api.axis_ctx(api.train_rules(False)):
        assert api.shard_hidden(x, "batch", None, "act_hidden") is x
    assert api.weight(x, torch.float32) is x
    assert torch.equal(api.heads_view(x, (2, 3, 2, 2), 2),
                       x.reshape(2, 3, 2, 2))
