"""The port's LM training losses and their gradients against the JAX
package, at smoke scale in float32.

``lm_loss`` for the nine decoder archs (dense, vlm from embeddings, moe,
ssm, hybrid) and ``encdec_loss`` for whisper-tiny, their values and every
parameter's gradient against ``jax.value_and_grad`` of the reference's
losses on the same weights (``bridge.master_from_jax``) and the same numpy
batch, through the trainer's ``make_grads_fn`` (the float32 cast copy in a
``functional_call`` of the model's skeleton). The JAX side runs its default
CPU backends (jnp). Tolerance 1e-4, relative and absolute, the absolute
part scaled by the largest entry of each gradient (as the CNN and BaF
gradients are held in ``tests/test_torch_train.py``). Also: the remat policies give exactly the gradients
of ``remat=False``; ``rmsnorm_lowmem`` against the JAX ``custom_vjp`` in
float32 and bf16, and the LM with ``norm_grad="bf16"`` against the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.encdec import encdec_loss as jax_encdec_loss
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch import configs
from repro_torch.bridge import lm_from_jax, master_from_jax
from repro_torch.models import lm as lm_module
from repro_torch.models.lm import REMAT_POLICIES, lm_loss
from repro_torch.nn import rmsnorm_apply, rmsnorm_lowmem_apply
from repro_torch.train.trainer import TrainConfig, make_grads_fn

ARCHS = ["qwen2_7b", "rwkv6_3b", "starcoder2_15b", "nemotron4_15b",
         "qwen2_72b", "olmoe_1b_7b", "arctic_480b", "zamba2_1p2b",
         "pixtral_12b"]
B, S = 2, 32
TOL = 1e-4


def randomize(params, rng):
    """Random norm scales and biases, QKV biases, token-shift mixes and
    Mamba-2 leaves: the JAX initialisers' constants would hide mistakes."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "bq", "bk", "bv"):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if name in ("mu_x", "mu_base", "cm_mu_k", "cm_mu_r"):
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        if name == "w0":
            return (rng.normal(size=a.shape) * 0.5 - 1.0).astype(np.float32)
        if name in ("conv_b", "A_log"):
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-3.0, -1.0, a.shape).astype(np.float32)
        if name == "D":
            return (1.0 + rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return a
    return walk(params)


def system(arch, **cfg_kw):
    """(JAX config, port config, numpy params, numpy batch)."""
    jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32, **cfg_kw)
    tcfg = configs.get_smoke_config(arch).with_(dtype=torch.float32,
                                                **cfg_kw)
    rng = np.random.default_rng(3)
    init = jax_init_encdec if jcfg.family == "audio" else jax_init_lm
    params = randomize(jax.tree.map(np.asarray,
                                    init(jax.random.PRNGKey(1), jcfg)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if jcfg.family == "audio":
        batch["audio_embeds"] = rng.normal(
            size=(B, 24, jcfg.d_model)).astype(np.float32)
    elif not jcfg.embed_inputs:
        batch["embeds"] = (rng.normal(size=(B, S, jcfg.d_model)) * 0.5) \
            .astype(np.float32)
        del batch["tokens"]
    return jcfg, tcfg, params, batch


def jax_value_and_grad(jcfg, params, batch, **kw):
    fn = jax_encdec_loss if jcfg.family == "audio" else jax_lm_loss
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: fn(p, jcfg, jb, **kw))(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_grads_close(got: dict, want: dict, tol=TOL):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(w.detach().abs().max())
        torch.testing.assert_close(g, w.detach(), atol=tol * max(scale, 1e-6),
                                   rtol=tol, msg=name)


@pytest.mark.parametrize("arch", ARCHS + ["whisper_tiny"])
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, params, batch = system(arch)
    want_loss, want = jax_value_and_grad(jcfg, params, batch)
    grads_of = make_grads_fn(tcfg, TrainConfig())
    loss, got = grads_of(master_from_jax(params, tcfg, device="cpu"),
                         torch_batch(batch))
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    assert_grads_close(got, master_from_jax(want, tcfg, device="cpu"))


def test_lowmem_norm_grad_matches_jax():
    """``norm_grad="bf16"``: the RMSNorms built by the LM take the
    low-memory backward, as the reference's ``_norm`` dispatches."""
    jcfg, tcfg, params, batch = system("qwen2_7b", norm_grad="bf16")
    want_loss, want = jax_value_and_grad(jcfg, params, batch)
    loss, got = make_grads_fn(tcfg, TrainConfig())(
        master_from_jax(params, tcfg, device="cpu"), torch_batch(batch))
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    assert_grads_close(got, master_from_jax(want, tcfg, device="cpu"))


def _module_grads(tcfg, params, batch, **kw):
    model = lm_from_jax(params, tcfg, device="cpu").requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    loss = lm_loss(model, torch_batch(batch), **kw)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    return loss, dict(zip(names, grads))


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("arch", ["qwen2_7b", "olmoe_1b_7b", "rwkv6_3b",
                                  "zamba2_1p2b"])
def test_remat_policies_equal_no_remat(arch, policy, monkeypatch):
    """Each policy recomputes what it does not keep (every layer's block
    runs again in the backward); the gradients are those of
    ``remat=False`` bit for bit (the same CPU arithmetic)."""
    _, tcfg, params, batch = system(arch)
    calls = []
    block = lm_module._layer_block

    def counted(*args, **kw):
        calls.append(1)
        return block(*args, **kw)
    monkeypatch.setattr(lm_module, "_layer_block", counted)
    loss0, want = _module_grads(tcfg, params, batch, remat=False)
    assert len(calls) == tcfg.n_layers
    loss, got = _module_grads(tcfg, params, batch, remat=True,
                              remat_policy=policy)
    assert len(calls) == 3 * tcfg.n_layers
    assert torch.equal(loss, loss0)
    for name, w in want.items():
        g = got[name]
        assert (g is None) == (w is None), name
        if w is not None:
            assert torch.equal(g, w), name


def test_remat_policy_names_are_checked():
    _, tcfg, params, batch = system("qwen2_7b")
    with pytest.raises(ValueError, match="remat_policy"):
        _module_grads(tcfg, params, batch, remat_policy="everything")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_lowmem_matches_jax_custom_vjp(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    g = rng.normal(size=(3, 5, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    y, vjp = jax.vjp(lambda s, t: jnn.rmsnorm_lowmem_apply({"scale": s}, t),
                     jnp.asarray(scale), jx)
    jds, jdx = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    ty = rmsnorm_lowmem_apply(tx, ts)
    tds, tdx = torch.autograd.grad(ty, (ts, tx), torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt and tdx.dtype == tdt and tds.dtype == torch.float32
    # the forward is rmsnorm_apply's
    assert torch.equal(ty, rmsnorm_apply(tx.detach(), ts.detach()))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((ty, y), (tdx, jdx), (tds, jds)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        torch.testing.assert_close(got.detach().float(), want, atol=tol,
                                   rtol=tol)


def test_kernel_autograd_functions_carry_the_plain_gradient(monkeypatch):
    """The autograd Functions around the flash and scan launches, driven on
    the CPU with each launch replaced by the plain version: the outputs
    carry a graph and the gradients (flash: q, k, v; the scan: q, k, v, a
    (B, S, H, 1) decay, the bonus and the initial state, through y and
    the final state) are autograd's through the plain versions."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, causal, window:
                        fa.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window))
    monkeypatch.setattr(ls, "_launch", lambda *a: ls.linear_scan_plain(
        *a[:4], bonus=a[4], initial_state=a[5], chunk=a[6], mode=a[7]))
    rng = np.random.default_rng(6)

    def leaf(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * 0.5,
                            requires_grad=True)
    q, k, v = leaf(2, 24, 4, 8), leaf(2, 40, 2, 8), leaf(2, 40, 2, 8)
    dout = torch.from_numpy(rng.normal(size=(2, 24, 4, 8)).astype(np.float32))
    out = fa._FlashAttention.apply(q, k, v, True, 9)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(
        fa.flash_attention_plain(q, k, v, causal=True, window=9),
        (q, k, v), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)

    q, k, v = leaf(2, 32, 3, 8), leaf(2, 32, 3, 8), leaf(2, 32, 3, 6)
    ld = (-torch.exp(leaf(2, 32, 3, 1) - 1.0)).detach().requires_grad_(True)
    s0 = leaf(2, 3, 8, 6)
    for bonus, mode in ((leaf(3, 8), "rwkv"), (None, "ssm")):
        inputs = [q, k, v, ld, bonus, s0]
        wrt = [t for t in inputs if t is not None]
        dy = torch.from_numpy(rng.normal(size=(2, 32, 3, 6))
                              .astype(np.float32))
        ds = torch.from_numpy(rng.normal(size=(2, 3, 8, 6))
                              .astype(np.float32))
        y, st = ls._LinearScan.apply(*inputs, 8, mode)
        assert y.grad_fn is not None and st.grad_fn is not None
        got = torch.autograd.grad((y, st), wrt, (dy, ds))
        want = torch.autograd.grad(ls.linear_scan_plain(
            q, k, v, ld, bonus=bonus, initial_state=s0, chunk=8, mode=mode),
            wrt, (dy, ds))
        for g, w, t in zip(got, want, wrt):
            assert g.shape == t.shape
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
