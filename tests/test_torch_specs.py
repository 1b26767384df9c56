"""The port's cell builders (``repro_torch.launch.specs``) against the
reference's ``repro.launch.specs``.

* ``SHAPES``, ``supported_shapes`` and ``make_batch_specs`` equal the
  reference's for every arch and shape (shapes and dtypes).
* ``build_cell``'s parameter, train-state, cache and batch specs on the
  (16, 16) and (2, 16, 16) production shapes equal the reference's
  ``in_shardings`` leaf by leaf, through the port's per-layer names (the
  reference stacks the layers on a leading dim, which the port's specs
  drop), for every arch's smoke config and every shape it supports, and
  for qwen2-7b's and arctic-480b's full configs. The reference's cells are
  built on an ``AbstractMesh`` (no devices); the port's on an object that
  names the same axes (a ``DeviceMesh`` needs a process group).
* ``_vocab_axis`` is None for whisper; the compressed multi-pod cell
  keeps no FSDP axis and replicates ``embed``/``lm_head`` (reference
  ``specs.py:131-149``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.distributed import api as japi
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import api
from repro_torch.launch import specs

ARCHS = configs.PORTED
MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
STACKS = ("layers", "enc_layers", "dec_layers")
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int32,
          jnp.float32: torch.float32}


class _Mesh:
    """What the port's builders read of a DeviceMesh: its axis names and
    sizes."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def _jax_mesh(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _spec(p, ndim):
    t = tuple(p)
    return t + (None,) * (ndim - len(t))


def _flat(tree):
    """{path names: PartitionSpec} of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    out = {}
    for path, s in flat:
        names = tuple(str(getattr(k, "key", getattr(k, "name",
                                                    getattr(k, "idx", k))))
                      for k in path)
        out[names] = s.spec if isinstance(s, NamedSharding) else s
    return out


def _check_params(got: dict, want: dict, like: dict, prefix=()):
    """Per-layer port specs against the reference's stacked ones."""
    assert got.keys() == like.keys()
    for name, leaf in like.items():
        parts = tuple(name.split("."))
        stacked = parts[0] in STACKS
        key = prefix + (parts[:1] + parts[2:] if stacked else parts)
        ref = _spec(want[key], leaf.dim() + stacked)
        assert got[name] == (ref[1:] if stacked else ref), (prefix, name)


def test_shapes_and_supported_shapes_are_the_references():
    assert SHAPES == JAX_SHAPES
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
        assert cfg.subquadratic == jcfg.subquadratic
        assert cfg.supported_shapes == jcfg.supported_shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_are_the_references(arch):
    cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
    for shape in SHAPES:
        got = specs.make_batch_specs(cfg, shape)
        want = jspecs.make_batch_specs(jcfg, shape)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, (shape, k)
            assert got[k].dtype == DTYPES[v.dtype.type], (shape, k)
            assert got[k].device.type == "meta"


def _cells(arch, shape, mesh_name, *, smoke=True, tcfg_overrides=None):
    shape_d = MESHES[mesh_name]
    multi_pod = "pod" in shape_d
    jcell = jspecs.build_cell(arch, shape, _jax_mesh(shape_d),
                              multi_pod=multi_pod, smoke=smoke,
                              tcfg_overrides=tcfg_overrides)
    cell = specs.build_cell(arch, shape, _Mesh(shape_d), multi_pod=multi_pod,
                            smoke=smoke, tcfg_overrides=tcfg_overrides)
    return cell, jcell


def _check_cell(cell, jcell):
    assert cell.kind == jcell.kind
    if cell.kind == "train":
        state, batch = cell.in_specs
        jstate, jbatch = (_flat(t) for t in jcell.in_shardings)
        params = cell.args[0].params
        _check_params(state.params, jstate, params, ("params",))
        _check_params(state.opt.mu, jstate, params, ("opt", "mu"))
        _check_params(state.opt.nu, jstate, params, ("opt", "nu"))
        assert state.opt.count == () and state.step == ()
        assert tuple(jstate[("opt", "count")]) == () \
            and tuple(jstate[("step",)]) == ()
        if state.ef is not None:
            _check_params(state.ef, jstate, params, ("ef",))
    else:
        p_specs, batch = cell.in_specs[0], cell.in_specs[-1]
        jp = _flat(jcell.in_shardings[0])
        _check_params(p_specs, jp, cell.args[0])
        jbatch = _flat(jcell.in_shardings[-1])
    if cell.kind in ("train", "prefill"):
        for k, spec in batch.items():
            assert spec == _spec(jbatch[(k,)], len(spec)), k
    else:   # a token (B,) or the long cell's tokens (B, S)
        want = jcell.in_shardings[-1].spec
        assert batch == _spec(want, len(batch))
    if cell.kind == "decode":
        c_specs = cell.in_specs[1]
        jc = _flat(jcell.in_shardings[1])
        seen = []

        def check(names, leaf):
            key = tuple(n for n in names if not n.isdigit())
            spec = _at(c_specs, names)
            ref = _spec(jc[key], leaf.dim() + 1)
            assert spec == ref[1:], names
            seen.append(key)
            return spec
        from repro_torch.distributed.sharding import _map_tensors
        _map_tensors(check, cell.args[1])
        assert set(seen) == {k for k in jc if k[-1] not in ("length", "pos")}


def _at(tree, names):
    for n in names:
        tree = tree[int(n)] if n.isdigit() else (
            getattr(tree, n) if hasattr(tree, "_fields") else tree[n])
    return tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_are_the_references(arch, mesh_name):
    for shape in configs.get_smoke_config(arch).supported_shapes:
        _check_cell(*_cells(arch, shape, mesh_name))


@pytest.mark.parametrize("arch,shape,mesh_name", [
    ("qwen2_7b", "train_4k", "16x16"), ("qwen2_7b", "decode_32k", "16x16"),
    ("arctic_480b", "train_4k", "pod2x16x16"),
    ("rwkv6_3b", "long_500k", "16x16")])
def test_full_config_cell_specs_are_the_references(arch, shape, mesh_name):
    _check_cell(*_cells(arch, shape, mesh_name, smoke=False))


def test_vocab_axis():
    rules = api.serve_rules(False)
    mesh = _Mesh(MESHES["16x16"])
    assert specs._vocab_axis(configs.get_config("whisper_tiny"), mesh,
                             rules) is None
    assert specs._vocab_axis(configs.get_config("qwen2_7b"), mesh,
                             rules) == "model"
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        assert specs._vocab_axis(configs.get_config(arch), mesh, rules) \
            == jspecs._vocab_axis(jcfg, _jax_mesh(MESHES["16x16"]),
                                  japi.serve_rules(False))


def test_compressed_cell_keeps_no_fsdp_axis():
    cell, jcell = _cells("qwen2_7b", "train_4k", "pod2x16x16",
                         tcfg_overrides={"grad_compress_bits": 8})
    _check_cell(cell, jcell)
    params = cell.in_specs[0].params
    assert cell.in_specs[0].ef is not None
    for name, spec in params.items():
        assert "data" not in spec and "pod" not in spec, name
        if name.split(".")[0] in ("embed", "lm_head"):
            assert all(e is None for e in spec), name
    assert any("model" in s for s in params.values())
