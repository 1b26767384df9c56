"""The port's Mamba-2 block against the JAX package, at smoke scale.

Weights come from the JAX ``init_lm`` of the zamba2-1.2b smoke config; its
constant initialisers (``A_log`` 0, ``dt_bias`` -2, ``D`` 1, zero conv
bias, unit norm scales) would hide mistakes, so they are overwritten with
numpy draws before ``bridge.lm_from_jax`` carries them across. The JAX side
runs its scan under the Pallas backend in interpret mode. Checked: the
block, the stateful segment (chained segments against one pass, states
included), the decode step, the causal conv, and the plain scan at
zamba2's chunk of 128 with a (B, S, H, 1) decay; 1e-4 in float32 and 3e-2
in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import linear_attention as JL
from repro.models import mamba2 as JM
from repro.models.lm import init_lm as jax_init_lm
from repro_torch import configs
from repro_torch.bridge import lm_from_jax
from repro_torch.kernels.linear_scan import _SMEM_BYTES, _smem_floats
from repro_torch.models import mamba2 as TM
from repro_torch.models.linear_attention import chunked_linear_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.fixture
def pallas_scan():
    JL.set_backend("pallas")
    yield
    JL.set_backend(None)


def randomize_mamba2(params, rng):
    """Random values for the Mamba-2 leaves the JAX init sets to constants
    (and for every norm scale and bias)."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        name = path[-1]
        draws = {
            "scale": lambda: rng.uniform(0.5, 1.5, a.shape),
            "bias": lambda: rng.normal(size=a.shape) * 0.1,
            "conv_b": lambda: rng.normal(size=a.shape) * 0.1,
            "A_log": lambda: rng.normal(size=a.shape) * 0.5,
            "dt_bias": lambda: rng.uniform(-3.0, -1.0, a.shape),
            "D": lambda: 1.0 + rng.normal(size=a.shape) * 0.3,
        }
        return draws[name]().astype(np.float32) if name in draws else a
    return walk(params)


def _block(dtype_name, seed=0):
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = jax_smoke_config("zamba2_1p2b").with_(dtype=jdt)
    tcfg = configs.get_smoke_config("zamba2_1p2b").with_(dtype=tdt)
    params = randomize_mamba2(jax_init_lm(jax.random.PRNGKey(seed), jcfg),
                              np.random.default_rng(seed + 1))
    model = lm_from_jax(params, tcfg, device="cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["layers"])
    s = tcfg.ssm
    kw = dict(state_dim=s.state_dim, head_dim=s.head_dim, expand=s.expand)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=model.layers[0], kw=kw,
                chunk=s.chunk, jdt=jdt, tdt=tdt, tol=tol)


def _x(cfg, shape, seed, jdt, tdt):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_block_matches_jax(pallas_scan, dtype):
    b = _block(dtype)
    jx, tx = _x(b["tcfg"], (2, 64, b["tcfg"].d_model), 3, b["jdt"], b["tdt"])
    got, st = TM.mamba2_block(b["tp"], tx, chunk=b["chunk"],
                              return_state=True, **b["kw"])
    want, jst = JM.mamba2_block(b["jp"], jx, chunk=b["chunk"],
                                return_state=True, **b["kw"])
    assert got.dtype == b["tdt"] and st.dtype == torch.float32
    _close(got, want, b["tol"])
    _close(st, jst, b["tol"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_segments_chain_like_one_pass(pallas_scan, dtype):
    """Four chained segments of 16 against the JAX segments (output, SSM
    state, conv carry) and, in the port, against one pass of 64."""
    b = _block(dtype, seed=1)
    cfg = b["tcfg"]
    jx, tx = _x(cfg, (2, 64, cfg.d_model), 4, b["jdt"], b["tdt"])
    st = TM.init_mamba2_state(2, cfg.d_model, conv_width=cfg.ssm.conv_width,
                              dtype=b["tdt"], device="cpu", **b["kw"])
    jst = JM.init_mamba2_state(2, cfg.d_model, conv_width=cfg.ssm.conv_width,
                               dtype=b["jdt"], **b["kw"])
    outs = []
    for i in range(4):
        seg = slice(16 * i, 16 * (i + 1))
        out, st = TM.mamba2_block_chunk(b["tp"], tx[:, seg], st,
                                        chunk=b["chunk"], **b["kw"])
        jout, jst = JM.mamba2_block_chunk(b["jp"], jx[:, seg], jst,
                                          chunk=b["chunk"], **b["kw"])
        _close(out, jout, b["tol"])
        _close(st.ssm, jst.ssm, b["tol"])
        _close(st.conv, jst.conv, b["tol"])
        outs.append(out)
    one, one_st = TM.mamba2_block(b["tp"], tx, chunk=b["chunk"],
                                  return_state=True, **b["kw"])
    if dtype == "float32":
        torch.testing.assert_close(torch.cat(outs, 1), one, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(st.ssm, one_st, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_step_matches_jax(dtype):
    b = _block(dtype, seed=2)
    cfg = b["tcfg"]
    rng = np.random.default_rng(5)
    ssm = rng.normal(size=(2, 2 * cfg.d_model // cfg.ssm.head_dim,
                           cfg.ssm.state_dim, cfg.ssm.head_dim))
    conv = rng.normal(size=(2, cfg.ssm.conv_width - 1,
                            2 * cfg.d_model + 2 * cfg.ssm.state_dim))
    st = TM.Mamba2State(ssm=torch.tensor(ssm, dtype=torch.float32),
                        conv=torch.tensor(conv, dtype=torch.float32)
                        .to(b["tdt"]))
    jst = JM.Mamba2State(ssm=jnp.asarray(ssm, jnp.float32),
                         conv=jnp.asarray(conv, jnp.float32).astype(b["jdt"]))
    for t in range(3):
        jx, tx = _x(cfg, (2, cfg.d_model), 10 + t, b["jdt"], b["tdt"])
        out, st = TM.mamba2_block_step(b["tp"], tx, st, **b["kw"])
        jout, jst = JM.mamba2_block_step(b["jp"], jx, jst, **b["kw"])
        _close(out, jout, b["tol"])
        _close(st.ssm, jst.ssm, b["tol"])
        _close(st.conv, jst.conv, b["tol"])


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_matches_jax(dtype, carry):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(24,)) * 0.1).astype(np.float32)
    c = rng.normal(size=(2, 3, 24)).astype(np.float32) if carry else None
    got, gc = TM._causal_depthwise_conv(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w),
        torch.from_numpy(bias),
        carry=None if c is None else torch.from_numpy(c).to(tdt))
    want, wc = JM._causal_depthwise_conv(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(bias),
        carry=None if c is None else jnp.asarray(c).astype(jdt))
    _close(got, want, tol if dtype == "bfloat16" else 1e-6)
    _close(gc, wc, 0.0)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_scan_at_chunk_128_with_a_scalar_decay(dtype, init):
    """zamba2's scan: ssm mode, a (B, S, H, 1) decay, chunk 128, dk = dv =
    64, against the JAX chunked engine."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(7)
    b, s, h, d = 1, 256, 2, 64
    q, k = ((rng.normal(size=(b, s, h, d)) * 0.3).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    ld = (-np.logaddexp(rng.normal(size=(b, s, h, 1)), 0.0) * 0.05) \
        .astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32) if init else None

    def cast(a, t):
        return None if a is None else (torch.from_numpy(a).to(t)
                                       if isinstance(t, torch.dtype)
                                       else jnp.asarray(a).astype(t))
    y, st = chunked_linear_attention(
        cast(q, tdt), cast(k, tdt), cast(v, tdt), torch.from_numpy(ld),
        chunk=128, mode="ssm", per_channel=False,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    wy, wst = JL.chunked_linear_attention(
        cast(q, jdt), cast(k, jdt), cast(v, jdt), jnp.asarray(ld), chunk=128,
        mode="ssm", per_channel=False,
        initial_state=None if s0 is None else jnp.asarray(s0))
    _close(y, wy, 1e-4)
    _close(st, wst, 1e-4)


def test_scan_kernel_fits_zamba2_chunk_with_a_scalar_decay():
    """The kernel's shared memory (the CUDA source's layout, mirrored by
    ``_smem_floats``): chunk 128 at dk = dv = 64 fits with a scalar decay
    in the tensor-core pass A (3 areas of 128 x 68 floats, 3 x 128
    vectors, 256 for la_end and 4 flags: 26,756 floats), and with a
    per-channel one in the same footprint (its log-decay takes v's area
    until v is loaded); rwkv6-3b's chunk 16 is as before."""
    assert _smem_floats(128, 64, 64, False) == 26756
    assert _smem_floats(128, 64, 64, False) * 4 <= _SMEM_BYTES
    assert _smem_floats(128, 64, 64, True) == 26756
    assert _smem_floats(128, 64, 64, True) * 4 <= _SMEM_BYTES
    # chunk 16: pass A 4 * 16 * 68 + 16 * 64 + 336 = 5,712 floats, pass B
    # two stages of 2,688 and the (64, 16) state slice
    assert _smem_floats(16, 64, 64, True) == 2 * 2688 + 64 * 16
