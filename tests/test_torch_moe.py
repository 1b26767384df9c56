"""The port's MoE layer against the JAX package, at smoke scale.

Weights come from the JAX ``init_lm`` of the olmoe-1b-7b and arctic-480b
smoke configs and are carried across by ``bridge.lm_from_jax``; inputs are
numpy draws. Routing is discontinuous (a rounding difference can move a
token to another expert), so the layer is held on identical inputs in both
dtypes: the routing tables (experts, slot positions, token table) must be
identical and the outputs within 1e-4 (float32) and 3e-2 (bf16). The
whole models are held in float32 by ``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as JM
from repro.models.lm import init_lm as jax_init_lm
from repro_torch import configs
from repro_torch.bridge import lm_from_jax
from repro_torch.configs.base import MoEConfig
from repro_torch.models.lm import (init_decode_cache, lm_decode_step,
                                   lm_forward)
from repro_torch.models.moe import capacity, moe_apply, route

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _jax_tables(x, router, mcfg, dtype):
    """The routing tables of ``repro.models.moe._route_one_group`` for one
    group, computed with the reference's own operations (it returns only
    the layer's output)."""
    t, _ = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    c = JM.capacity(t, mcfg)
    logits = (x @ router.astype(dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    counts = jnp.zeros((e,), jnp.int32)
    token_for = jnp.full((e, c + 1), t, jnp.int32)
    slot_pos = []
    for j in range(k):
        oh = jax.nn.one_hot(top_e[:, j], e, dtype=jnp.int32)
        pos_in = jnp.cumsum(oh, axis=0) - 1 + counts[None, :]
        pos_j = jnp.sum(pos_in * oh, axis=1)
        counts = counts + jnp.sum(oh, axis=0)
        pos_j = jnp.where(pos_j < c, pos_j, c)
        token_for = token_for.at[top_e[:, j], pos_j].set(jnp.arange(t),
                                                         mode="drop")
        slot_pos.append(pos_j)
    token_for = token_for.at[:, c].set(t)
    return (np.asarray(top_p), np.asarray(top_e),
            np.asarray(jnp.stack(slot_pos, 1)), np.asarray(token_for))


def _layer(arch, dtype_name, seed=0):
    """Layer 0's MoE params in both packages (the MoE layer has no scale or
    bias for ``init_lm`` to leave at a constant)."""
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = jax_smoke_config(arch).with_(dtype=jdt)
    tcfg = configs.get_smoke_config(arch).with_(dtype=tdt)
    params = jax.tree.map(np.asarray,
                          jax_init_lm(jax.random.PRNGKey(seed), jcfg))
    model = lm_from_jax(params, tcfg, device="cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["layers"]["moe"])
    return jcfg, tcfg, jp, model.layers[0].moe, tol


def _inputs(cfg, g, t, seed, skew=0.0, router=None):
    """(G, T, D) float32 draws; ``skew`` adds the direction of expert 0's
    router column, so that most tokens pick expert 0 and its slots
    overflow."""
    x = np.random.default_rng(seed).normal(size=(g, t, cfg.d_model))
    if skew:
        col = np.asarray(router[:, 0], np.float64)
        x = x + skew * col / np.linalg.norm(col)
    return x.astype(np.float32)


def _both(x, jdt, tdt):
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("t", [1, 2, 16, 63, 512, 4096])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b"])
@pytest.mark.parametrize("full", [False, True])
def test_capacity_matches_jax(arch, full, t):
    get_t = configs.get_config if full else configs.get_smoke_config
    get_j = jax_get_config if full else jax_smoke_config
    assert capacity(t, get_t(arch).moe) == JM.capacity(t, get_j(arch).moe)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("e,k", [(8, 2), (64, 8), (128, 2)])
def test_capacity_grid_matches_jax(e, k, cf):
    for t in (1, 7, 8, 100, 511, 512, 2048):
        got = capacity(t, MoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                                    capacity_factor=cf))
        want = JM.capacity(t, JaxMoEConfig(num_experts=e, top_k=k,
                                           d_ff_expert=8, capacity_factor=cf))
        assert got == want and got % 8 == 0 and got >= 8


@pytest.mark.parametrize("skew", [0.0, 6.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b"])
def test_routing_tables_and_output_match_jax(arch, dtype, skew):
    jcfg, tcfg, jp, tp, tol = _layer(arch, dtype)
    jdt, tdt, _ = DTYPES[dtype]
    x = _inputs(tcfg, 2, 64, seed=3, skew=skew, router=jp["router"])
    jx, tx = _both(x, jdt, tdt)
    routes = []
    y, aux = moe_apply(tp, tx, tcfg.moe, routes=routes)
    (r,) = routes
    c = capacity(64, tcfg.moe)
    for gi in range(2):
        top_p, top_e, slot_pos, token_for = _jax_tables(
            jx[gi], jp["router"], jcfg.moe, jdt)
        np.testing.assert_array_equal(r.top_e[gi].numpy(), top_e)
        np.testing.assert_array_equal(r.slot_pos[gi].numpy(), slot_pos)
        np.testing.assert_array_equal(r.token_for[gi].numpy(), token_for)
        np.testing.assert_allclose(r.top_p[gi].numpy(), top_p, atol=1e-6,
                                   rtol=1e-6)
    dropped = int((r.slot_pos == c).sum())
    if skew:       # the skewed inputs overflow expert 0's capacity
        assert dropped > 0 and int((r.top_e[..., 0] == 0).sum()) > c
    jy, jaux = JM.moe_apply(jp, jx, jcfg.moe, jcfg.act, jcfg.d_ff)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=1e-5)


def test_dropped_slots_read_the_zero_row():
    """A slot that overflowed its expert adds nothing: each token's output
    is the gated sum of its kept slots' expert FFNs, computed token by
    token."""
    _, tcfg, jp, tp, _ = _layer("olmoe_1b_7b", "float32")
    x = torch.from_numpy(_inputs(tcfg, 1, 64, seed=4, skew=8.0,
                                 router=jp["router"]))
    routes = []
    y, _ = moe_apply(tp, x, tcfg.moe, routes=routes)
    r = routes[0]
    c = capacity(64, tcfg.moe)
    assert int((r.slot_pos == c).sum()) > 0
    want = torch.zeros_like(y)
    for t in range(64):
        for j in range(tcfg.moe.top_k):
            if int(r.slot_pos[0, t, j]) == c:
                continue
            e = int(r.top_e[0, t, j])
            xt = x[0, t]
            h = torch.nn.functional.silu(xt @ tp.wgate[e]) * (xt @ tp.wup[e])
            want[0, t] += r.top_p[0, t, j] * (h @ tp.wdown[e])
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


def test_arctic_dense_residual_matches_jax():
    jcfg, tcfg, jp, tp, _ = _layer("arctic_480b", "float32", seed=1)
    assert tp.dense is not None and "dense" in jp
    x = _inputs(tcfg, 2, 32, seed=5)
    y, _ = moe_apply(tp, torch.from_numpy(x), tcfg.moe)
    jy, _ = JM.moe_apply(jp, jnp.asarray(x), jcfg.moe, jcfg.act, jcfg.d_ff)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    # the residual is really in it: without it the output moves
    experts_only, _ = JM.moe_apply({k: v for k, v in jp.items()
                                    if k != "dense"}, jnp.asarray(x),
                                   dataclasses.replace(
                                       jcfg.moe, dense_residual=False),
                                   jcfg.act, jcfg.d_ff)
    assert float(np.abs(np.asarray(experts_only) - y.numpy()).max()) > 1e-3


def test_topk_ties_go_to_the_lower_expert():
    """Equal router probabilities (a zero input: every logit 0) pick the
    lowest expert indices in order, as ``jax.lax.top_k`` does."""
    _, tcfg, jp, tp, _ = _layer("olmoe_1b_7b", "bfloat16")
    x = torch.zeros((1, 8, tcfg.d_model), dtype=torch.bfloat16)
    x[0, 4:] = torch.randn((4, tcfg.d_model)).to(torch.bfloat16)
    r = route(x, tp.router, tcfg.moe, torch.bfloat16)
    k = tcfg.moe.top_k
    assert r.top_e[0, :4].tolist() == [list(range(k))] * 4
    _, top_e, _, _ = _jax_tables(jnp.asarray(x[0].float().numpy())
                                 .astype(jnp.bfloat16), jp["router"],
                                 jax_smoke_config("olmoe_1b_7b").moe,
                                 jnp.bfloat16)
    np.testing.assert_array_equal(r.top_e[0].numpy(), top_e)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b"])
def test_moe_prefill_equals_cache_fill_when_nothing_drops(arch):
    """Prefill routes each batch row as a group of S tokens, decode the B
    tokens of a step as one group: the two agree where no slot is dropped
    in either. The smoke configs have 8 experts: an 8-token prompt has
    capacity 8, which no expert can exceed (at 12 and 16 tokens some expert
    gets 9 or 10 of its rows in these weights, and at 512 most would).
    ``chip_smoke.py`` holds the full configs at an 8-token prompt for the
    same reason: capacity is then 8, and a token takes an expert at most
    once, so no expert can get more rows than it has slots."""
    tcfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(2),
                                                  jax_smoke_config(arch)))
    model = lm_from_jax(params, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, 8)))
    routes = []
    logits, aux = lm_forward(model, tokens=toks, routes=routes)
    c = capacity(8, tcfg.moe)
    assert len(routes) == tcfg.n_layers and float(aux) > 0
    assert all(int((r.slot_pos == c).sum()) == 0 for r in routes)
    cache = init_decode_cache(tcfg, 2, 8, device="cpu")
    for t in range(8):
        last, cache = lm_decode_step(model, cache, toks[:, t])
    torch.testing.assert_close(last, logits[:, -1], atol=1e-5, rtol=1e-5)
