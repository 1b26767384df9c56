"""The port's distributed layer (``repro_torch.distributed``,
``optim/grad_compress.py``, the flash-decode branch of ``attention_decode``)
against the reference's own code.

* Rule tables and specs: ``param_pspec`` and ``cache_pspecs`` equal the
  JAX specs leaf by leaf for all ten archs' smoke params and caches, with
  the reference's stacked layer dim dropped; ``to_placements`` gives the
  expected local shapes on a 2 x 2 gloo mesh, and ``shard_hidden``
  redistributes a DTensor and leaves a plain tensor alone.
* ``_quantized_psum_one`` at 2 and 4 pods, 8 and 16 bits, on gradients
  that differ from pod to pod: each pod's mean and residual against the
  reference's per-shard function run under ``jax.vmap(...,
  axis_name="pod")`` (its pmax and ppermute ring), within 1e-6 of the
  leaf's largest entry (a code that differs would show as a step of
  amax/levels, ~100x that).
* ``seq_sharded_decode_attention`` at W = 2 and 4 with ``length`` inside
  the shards and on their edges: against ``_local_update`` +
  ``_partial_attention`` under vmap over the model axis and against the
  plain one-token decode, at 1e-5; the shards' slots bit for bit. A smoke
  LM decoded under ``flash_decode_ctx`` at W = 2 against the unsharded
  decode.

Ranks are gloo processes on the CPU (``tests/torch_ranks.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import api as japi
from repro.distributed import sharding as jsharding
from repro.distributed.collectives import _local_update, _partial_attention
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.encdec import init_encdec_cache as jax_init_encdec_cache
from repro.models.lm import init_decode_cache as jax_init_decode_cache
from repro.models.lm import init_lm as jax_init_lm
from repro.optim.grad_compress import _quantized_psum_one as jax_psum_one
from repro_torch import configs
from repro_torch.distributed import api, sharding
from repro_torch.models.encdec import EncDec, init_encdec_cache
from repro_torch.models.lm import LM, init_decode_cache, init_lm, \
    lm_decode_step
from repro_torch.optim.adamw import AdamWState

import torch_ranks

ARCHS = configs.PORTED
MESHES = [{"pod": 2, "data": 2, "model": 2}, {"pod": 1, "data": 4, "model": 8}]
STACKS = ("layers", "enc_layers", "dec_layers")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _spec(p, ndim):
    """A PartitionSpec as the port's spec: one entry a dim."""
    t = tuple(p)
    return t + (None,) * (ndim - len(t))


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {jsharding._path_names(path): s for path, s in flat}


def test_rule_tables_are_the_references():
    for multi_pod in (False, True):
        for seq in (False, True):
            assert api.train_rules(multi_pod, seq_parallel=seq).rules == \
                japi.train_rules(multi_pod, seq_parallel=seq).rules
            for mode in ("2d", "tp"):
                assert api.serve_rules(multi_pod, weight_mode=mode,
                                       seq_parallel=seq).rules == \
                    japi.serve_rules(multi_pod, weight_mode=mode,
                                     seq_parallel=seq).rules
    assert sharding._RULES == jsharding._RULES


def test_logical_axes_noop_outside_context():
    assert api.logical_axes("batch", None, "ffn") is None
    x = torch.zeros(2, 3)
    assert api.shard_hidden(x, "batch", "ffn") is x
    rules = {"batch": ("pod", "data"), "ffn": "model"}
    with api.axis_ctx(api.AxisRules(rules=rules)), \
            japi.axis_ctx(japi.AxisRules(rules=rules)):
        assert api.logical_axes("batch", None, "ffn") == \
            tuple(japi.logical_axes("batch", None, "ffn")) == \
            (("pod", "data"), None, "model")
    assert api.logical_axes("batch") is None


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2x2", "1x4x8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, mesh):
    jcfg = jax_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    init = jax_init_encdec if jcfg.family == "audio" else jax_init_lm
    abstract = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    want = _jax_specs(jsharding.params_pspecs(abstract, _FakeMesh(mesh)))
    skeleton = (EncDec if cfg.family == "audio" else LM)(cfg, device="meta")
    params = dict(skeleton.named_parameters())
    got = sharding.params_pspecs(params, mesh)
    assert got.keys() == params.keys()
    for name, p in params.items():
        parts = tuple(name.split("."))
        stacked = parts[0] in STACKS
        key = parts[:1] + parts[2:] if stacked else parts
        ref = _spec(want[key], p.ndim + stacked)
        assert got[name] == (ref[1:] if stacked else ref), name
    opt = sharding.opt_state_pspecs(AdamWState(0, {}, {}), got)
    assert opt.count == () and opt.mu is got and opt.nu is got


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2x2", "1x4x8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch, mesh):
    jcfg = jax_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    b, max_len = 4, 16
    if jcfg.family == "audio":
        jparams = jax.eval_shape(
            lambda: jax_init_encdec(jax.random.PRNGKey(0), jcfg))
        enc = jax.ShapeDtypeStruct((b, 8, jcfg.d_model), jnp.float32)
        jcache = jax.eval_shape(
            lambda p, e: jax_init_encdec_cache(p, jcfg, e, max_len),
            jparams, enc)
        cache = init_encdec_cache(EncDec(cfg, device="meta"),
                                  torch.zeros(b, 8, cfg.d_model,
                                              device="meta"), max_len)
    else:
        jcache = jax.eval_shape(
            lambda: jax_init_decode_cache(jcfg, b, max_len))
        cache = init_decode_cache(cfg, b, max_len, device="meta")
    for batch_axes in ("data", ("pod", "data"), None):
        for fallback in (True, False):
            want = _jax_specs(jsharding.cache_pspecs(
                jcache, _FakeMesh(mesh), batch_axes, seq_fallback=fallback))
            got = sharding.cache_pspecs(cache, mesh, batch_axes,
                                        seq_fallback=fallback)
            seen = []

            def check(names, leaf):
                key = tuple(n for n in names if not n.isdigit())
                spec = got_at(got, names)
                ref = _spec(want[key], leaf.ndim + 1)
                assert spec == ref[1:], (names, batch_axes)
                seen.append(key)
                return spec
            sharding._map_tensors(check, cache)
            assert set(seen) == {k for k, v in want.items()
                                 if k[-1] not in ("length", "pos")}


def got_at(tree, names):
    for n in names:
        tree = tree[int(n)] if n.isdigit() else (
            getattr(tree, n) if hasattr(tree, "_fields") else tree[n])
    return tree


def test_batch_pspec_matches_jax():
    for mesh in MESHES + [{"pod": 2, "data": 16, "model": 16}]:
        for gb in (1, 2, 4, 6, 8, 256):
            for multi_pod in (False, True):
                assert sharding.batch_pspec(gb, mesh, multi_pod=multi_pod) \
                    == jsharding.batch_pspec(gb, _FakeMesh(mesh),
                                             multi_pod=multi_pod)


def test_to_placements_local_shapes(tmp_path):
    """4 gloo ranks as (pod 1, data 2, model 2)."""
    cases = [((8, 6), ("data", "model")), ((8, 6), (("data", "model"), None)),
             ((8, 6), (None, None)), ((8, 6), ("model", None)),
             ((4, 8, 6), (("pod", "data"), None, "model"))]
    want = [(4, 3), (2, 6), (8, 6), (4, 6), (2, 8, 3)]
    res = torch_ranks.spawn(torch_ranks.placements_rank, 4, (1, 2, 2),
                            tmp_path, cases)
    x = torch.arange(8 * 4 * 6.0).reshape(8, 4, 6)
    for r in res:
        assert r["shapes"] == want
        assert r["hidden"] == (4, 4, 3)
        assert r["placements"] == (Replicate(), Shard(0), Shard(2))
        assert torch.equal(r["full"], x) and r["plain_is_x"]
    with pytest.raises(ValueError, match="shards dims"):
        sharding.to_placements(("model", "model"),
                               type("M", (), {"mesh_dim_names": ("model",)}))


# ---------------------------------------------------------------------------
# The compressed cross-pod mean
# ---------------------------------------------------------------------------

PSUM_SHAPES = {"w": (16, 24), "b": (24,), "e": (3, 5, 7), "zero": (4, 4)}


def _pod_grads(world: int, seed: int) -> dict:
    """Leaves that differ from pod to pod (pod p scaled by 1 + p / 2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in PSUM_SHAPES.items():
        g = rng.normal(size=(world,) + shape).astype(np.float32)
        g *= (1 + np.arange(world) / 2).reshape((world,) + (1,) * len(shape))
        out[k] = g * (0 if k == "zero" else 1)
    return out


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    runs = {}
    for world in (2, 4):
        cases = [(bits, _pod_grads(world, bits)) for bits in (8, 16)]
        res = torch_ranks.spawn(torch_ranks.psum_rank, world, (world, 1, 1),
                                tmp_path_factory.mktemp("psum"), cases)
        for i, (bits, leaves) in enumerate(cases):
            runs[world, bits] = (leaves, [r[i] for r in res])
    return runs


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("world", [2, 4])
def test_quantized_psum_matches_vmap_oracle(psum_runs, world, bits):
    leaves, ranks = psum_runs[world, bits]
    for k, g in leaves.items():
        mean, resid = jax.vmap(
            lambda x: jax_psum_one(x, bits, "pod", world),
            axis_name="pod")(jnp.asarray(g))
        tol = 1e-6 * max(float(np.abs(g).max()), 1e-30)
        for pod, (means, residuals) in enumerate(ranks):
            assert means[k].dtype == torch.float32
            np.testing.assert_allclose(means[k].numpy(),
                                       np.asarray(mean[pod]), rtol=0,
                                       atol=tol, err_msg=k)
            np.testing.assert_allclose(residuals[k].numpy(),
                                       np.asarray(resid[pod]), rtol=0,
                                       atol=tol, err_msg=k)
            # every pod holds the same mean
            assert torch.equal(means[k], ranks[0][0][k])
        exact = g.mean(0)
        step = float(np.abs(g).max()) / ((1 << (bits - 1)) - 1)
        assert np.abs(ranks[0][0][k].numpy() - exact).max() <= step


# ---------------------------------------------------------------------------
# Flash-decode over a sequence-sharded cache
# ---------------------------------------------------------------------------

DEC = dict(b=2, h=6, kh=3, hd=16, s=32)


def _decode_cases(world: int):
    """The caches filled with random entries up to ``length`` (later slots
    hold stale values the softmax must not see)."""
    rng = np.random.default_rng(world)
    b, h, kh, hd, s = (DEC[k] for k in ("b", "h", "kh", "hd", "s"))
    s_loc = s // world
    lengths = sorted({0, s_loc - 1, s_loc, s_loc + 1, s // 2 + 3, s - 1})
    cases = []
    for length in lengths:
        f = lambda *shape: rng.normal(size=shape).astype(np.float32)
        cases.append((f(b, h, hd), f(b, s, kh, hd), f(b, s, kh, hd),
                      f(b, kh, hd), f(b, kh, hd), length))
    return cases


def _plain_decode(q, ck, cv, nk, nv, length):
    ck, cv = ck.copy(), cv.copy()
    ck[:, length], cv[:, length] = nk, nv
    b, h, hd = q.shape
    kh = ck.shape[2]
    qg = torch.from_numpy(q).reshape(b, kh, h // kh, hd).double()
    k = torch.from_numpy(ck[:, :length + 1]).double()
    v = torch.from_numpy(cv[:, :length + 1]).double()
    p = torch.softmax(torch.einsum("bkgh,bskh->bkgs", qg, k) / np.sqrt(hd),
                      -1)
    return torch.einsum("bkgs,bskh->bkgh", p, v).reshape(b, h * hd), ck, cv


@pytest.fixture(scope="module")
def decode_runs(tmp_path_factory):
    return {world: (cases, torch_ranks.spawn(
        torch_ranks.decode_rank, world, (1, 1, world),
        tmp_path_factory.mktemp("decode"), cases))
        for world in (2, 4) for cases in [_decode_cases(world)]}


@pytest.mark.parametrize("world", [2, 4])
def test_seq_sharded_decode_matches_oracles(decode_runs, world):
    cases, ranks = decode_runs[world]
    s_loc = DEC["s"] // world
    for i, (q, ck, cv, nk, nv, length) in enumerate(cases):
        shard = lambda c: jnp.asarray(c).reshape(
            c.shape[0], world, s_loc, *c.shape[2:]).swapaxes(0, 1)

        def f(qf, k, v, n_k, n_v, ln):
            k = _local_update(k, n_k[:, None], ln, "model", s_loc)
            v = _local_update(v, n_v[:, None], ln, "model", s_loc)
            return _partial_attention(qf[:, :, None, :], k, v, ln, "model",
                                      s_loc), k, v
        want, wk, wv = jax.vmap(f, in_axes=(None, 0, 0, None, None, None),
                                axis_name="model")(
            jnp.asarray(q), shard(ck), shard(cv), jnp.asarray(nk),
            jnp.asarray(nv), jnp.int32(length))
        plain, pk, pv = _plain_decode(q, ck, cv, nk, nv, length)
        tol = 1e-5 * float(plain.abs().max())
        for rank, res in enumerate(ranks):
            out, lk, lv = res[i]
            assert out.dtype == torch.float32 and out.shape == plain.shape
            np.testing.assert_allclose(out.numpy(), np.asarray(want[rank]),
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(out.double().numpy(), plain.numpy(),
                                       rtol=0, atol=tol)
            assert np.array_equal(lk.numpy(), np.asarray(wk[rank]))
            assert np.array_equal(lv.numpy(), np.asarray(wv[rank]))
            sl = slice(rank * s_loc, (rank + 1) * s_loc)
            assert np.array_equal(lk.numpy(), pk[:, sl])
            assert np.array_equal(lv.numpy(), pv[:, sl])


@pytest.mark.parametrize("arch", ["qwen2_7b", "zamba2_1p2b"])
def test_lm_decode_under_flash_decode_ctx(tmp_path, arch):
    """W = 2 over the model axis: every step's logits against the
    unsharded decode of the same seeded smoke LM, each rank holding half
    the cache slots."""
    cfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    steps, max_len = 4, 16
    res = torch_ranks.spawn(torch_ranks.lm_decode_rank, 2, (1, 1, 2),
                            tmp_path, arch, tokens, steps, max_len)
    model = init_lm(cfg, seed=0, device="cpu")
    cache = init_decode_cache(cfg, 2, max_len, device="cpu")
    want = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lt, cache = lm_decode_step(model, cache,
                                       torch.from_numpy(tokens[:, t]))
            want.append(lt)
        for _ in range(steps):
            lt, cache = lm_decode_step(model, cache, lt.argmax(-1))
            want.append(lt)
    want = torch.stack(want)
    for logits, slots, refusal in res:
        assert set(slots) == {max_len // 2}
        assert float((logits - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        assert "neither a window" in refusal
