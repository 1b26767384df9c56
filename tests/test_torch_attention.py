"""The port's attention against the JAX package, on the CPU.

The flash wrapper runs its plain version here; it is held to the JAX flash
kernel (``ops.flash_attention``, interpret mode, lengths that are 128 or a
multiple of it so JAX really takes its kernel) and to
``ref.flash_attention_ref``. RoPE, the GQA repeat, ``blocked_attention``,
``attention_apply`` (both impls; JAX under its Pallas backend) and the
KV-cache decode are held to their JAX counterparts. Inputs are numpy draws
from fixed seeds. Tolerances: 2e-5 in float32 and 3e-2 in bf16 for the
flash comparisons (the JAX kernel tests' own), 1e-5 for RoPE (float32
transcendental rounding), 1e-4 through a projected layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as TA

FLASH_CASES = [
    # B, Sq, Sk, H, KH, hd, causal, window
    (2, 128, 128, 4, 2, 16, True, None),
    (1, 128, 128, 4, 4, 32, False, None),
    (1, 128, 128, 7, 1, 16, True, 48),          # GQA 7, window
    (2, 64, 128, 4, 2, 16, True, None),         # Sq < Sk, aligned causal
    (1, 256, 256, 2, 1, 64, True, None),
]
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 3e-2}
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture
def pallas_attention():
    JA.set_backend("pallas")
    yield
    JA.set_backend(None)


def _qkv(seed, b, sq, sk, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kh, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kh, hd)).astype(np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_ref(dtype, case):
    b, sq, sk, h, kh, hd, causal, window = case
    q, k, v = _qkv(0, b, sq, sk, h, kh, hd)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want_kernel = ops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window)
    g = h // kh
    want_ref = ref.flash_attention_ref(jq, jnp.repeat(jk, g, axis=2),
                                       jnp.repeat(jv, g, axis=2),
                                       causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH[dtype] and got.shape == (b, sq, h, hd)
    tol = TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), _f32(want), atol=tol,
                                   rtol=tol)


def test_flash_wrapper_validates():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, q[:, :5], q[:, :5], causal=True)
    assert flash_attention(q, q[:, :5], q[:, :5], causal=False).shape == q.shape
    # meta (the dry run): an empty output of q's shape and dtype
    out = flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 3, 16)).astype(np.float32)
    for pos in (np.arange(37), rng.integers(0, 5000, size=(2, 37))):
        jc, js = JA.rope_freqs(16, 1e6, jnp.asarray(pos))
        tc, ts = TA.rope_freqs(16, 1e6, torch.from_numpy(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        np.testing.assert_allclose(
            TA.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(JA.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)


def test_repeat_kv_matches_jax():
    k = np.random.default_rng(2).normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        TA.repeat_kv(torch.from_numpy(k), 12).numpy(),
        np.asarray(JA.repeat_kv(jnp.asarray(k), 12)))


@pytest.mark.parametrize("causal,q_offset,window",
                         [(True, 0, None), (True, 64, 40), (False, 0, 24)])
def test_blocked_attention_matches_jax(causal, q_offset, window):
    q, k, v = _qkv(3, 2, 64, 128, 4, 4, 16)
    want = JA.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, q_offset=q_offset,
                                window=window, q_block=16)
    got = TA.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               q_offset=q_offset, window=window, q_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _layer(seed=0, d=64, h=4, kh=2, hd=16):
    """JAX attention params with random biases, and the port's copy."""
    rng = np.random.default_rng(seed)
    p = JA.init_attention(jax.random.PRNGKey(seed), d, h, kh, hd,
                          qkv_bias=True)
    p = {k: np.asarray(a) for k, a in p.items()}
    for name in ("bq", "bk", "bv"):
        p[name] = (rng.normal(size=p[name].shape) * 0.1).astype(np.float32)
    mod = TA.Attention(d, h, kh, hd, qkv_bias=True, device="cpu")
    with torch.no_grad():
        for name, a in p.items():
            getattr(mod, name).copy_(torch.tensor(a))
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, rope_theta=1e4)
    return jax.tree.map(jnp.asarray, p), mod, kw


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("impl", TA.IMPLS)
def test_attention_apply_matches_jax(pallas_attention, impl, window):
    jp, mod, kw = _layer()
    x = np.random.default_rng(4).normal(size=(2, 128, 64)).astype(np.float32)
    want = JA.attention_apply(jp, jnp.asarray(x), causal=True, window=window,
                              **kw)
    got = TA.attention_apply(mod, torch.from_numpy(x), causal=True,
                             window=window, impl=impl, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_attention_decode_matches_jax():
    jp, mod, kw = _layer(seed=1)
    rng = np.random.default_rng(5)
    jc = JA.init_kv_cache(2, 8, 2, 16, jnp.float32)
    tc = TA.init_kv_cache(2, 8, 2, 16, torch.float32, device="cpu")
    for _ in range(4):
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jy, jc = JA.attention_decode(jp, jnp.asarray(x), jc, **kw)
        ty, tc = TA.attention_decode(mod, torch.from_numpy(x), tc, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
    assert tc.length == int(jc.length) == 4
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-6)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-6)
    with pytest.raises(ValueError, match="full"):
        for _ in range(5):
            _, tc = TA.attention_decode(mod, torch.zeros((2, 1, 64)), tc,
                                        **kw)
