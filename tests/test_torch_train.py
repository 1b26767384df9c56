"""The port's offline side (training BN, the CNN's training forward, the
loss, AdamW and its schedules, the BaF loss with quantization in the loop,
the trainers, checkpoints) against the JAX package.

A tiny CNN (width 0.125, 32x32, P=32, Q=16) and BaF (C=4, hidden 8);
weights are drawn by the JAX initialisers, with BN statistics and PReLU
slopes randomised from numpy, and bridged into the port. Inputs are numpy
arrays from a seed. Tolerances:

* charbonnier and the schedules 1e-6 (float32, one op order apart);
* AdamW rtol 1e-6 on params and moments, fed the same numpy gradients,
  with atol 1e-6 x the leaf's max |value| (the two global norms are summed
  in other orders, so the clip scales can differ in the last bit, and a
  moment near 0 is a difference of such products);
* training BN and its running stats 1e-5 (the convolutions' 1e-5 of
  ``test_torch_nn.py``);
* losses 1e-4 and gradients rtol 1e-4 with atol 1e-4 x the leaf's max |g|
  (float32 convolutions and their transposes summed in other orders);
* codes bit-identical; multi-step losses 1e-3 (Adam's first step is about
  lr * sign(g), so a rounding difference in a near-zero gradient can move
  one weight by 2 lr: trajectories are held by their losses).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.core import losses as jlosses
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import baf_conv_predict as jax_baf_predict
from repro.core.baf import init_baf_conv
from repro.core.quant import compute_quant_params, quantize
from repro.data.synthetic import ShapesDatasetConfig as JData
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.models.cnn import cnn_edge, cnn_forward_train, init_cnn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import constant_lr as jconstant_lr
from repro.optim import cosine_with_warmup as jcosine
from repro.train import baf_trainer as jtrainer
from repro.train import checkpoint as jckpt
from repro_torch import nn as tnn
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.core import losses as tlosses
from repro_torch.core.baf import BaFConvConfig, baf_conv_predict
from repro_torch.data.synthetic import ShapesDatasetConfig, \
    shapes_batch_iterator
from repro_torch.kernels import quantize as tquant
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    constant_lr, cosine_with_warmup
from repro_torch.train import baf_trainer as ttrainer
from repro_torch.train import checkpoint as tckpt

C, HIDDEN, BITS = 4, 8, 8
GRAD_TOL = 1e-4
CFG = dict(width_mult=0.125, input_size=32, num_classes=8, tail_res_blocks=1)
JCFG, TCFG = JCNNConfig(**CFG), CNNConfig(**CFG)
DATA = dict(image_size=32, num_classes=8, batch_size=4)
JDATA, TDATA = JData(**DATA), ShapesDatasetConfig(**DATA)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and beside other test processes a pool of threads per op spends more
    time waiting for its threads than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, rng):
    """Random BN statistics and PReLU slopes, as numpy float32 leaves."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape
            return {k: v.astype(np.float32) for k, v in {
                "scale": rng.uniform(0.5, 1.5, n),
                "bias": rng.normal(size=n) * 0.1,
                "mean": rng.normal(size=n) * 0.1,
                "var": rng.uniform(0.5, 2.0, n)}.items()}
        if set(tree) == {"alpha"}:
            return {"alpha": rng.uniform(0.0, 0.5, tree["alpha"].shape)
                    .astype(np.float32)}
        return {k: _randomize(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    params = _randomize(jax.jit(init_cnn, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG), rng)
    baf = _randomize(jax.jit(init_baf_conv, static_argnums=1)(
        jax.random.PRNGKey(1), JBaFConfig(c=C, q=JCFG.split_q,
                                          hidden=HIDDEN)), rng)
    sel = rng.permutation(TCFG.split_p)[:C]
    imgs = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
            for _ in range(4)]
    labels = [rng.integers(0, 8, size=4) for _ in range(4)]
    return dict(params=params, baf=baf, sel=sel, imgs=imgs, labels=labels)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cnn(s):
    return cnn_from_jax(s["params"], TCFG, device="cpu")


def _baf(s):
    return baf_from_jax(s["baf"], BaFConvConfig(c=C, q=TCFG.split_q,
                                                hidden=HIDDEN), device="cpu")


def _jax_leaf(tree, name: str) -> np.ndarray:
    """The JAX leaf of a port parameter name, in the port's layout:
    ``stem.3.conv.weight`` -> tree["stem"][3]["conv"]["w"] as OIHW."""
    node = tree
    parts = name.split(".")
    for part in parts[:-1]:
        node = node[int(part)] if part.isdigit() else node[part]
    key = parts[-1]
    if key == "weight" or (key == "bias" and key not in node):
        key = key[0]                                      # conv, dense: w, b
    leaf = np.asarray(node[key])
    if leaf.ndim == 4:
        leaf = leaf.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    return leaf


def _assert_grads(named_grads: dict, jgrads) -> None:
    assert named_grads
    for name, g in named_grads.items():
        want = _jax_leaf(jgrads, name)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)


# ---------------------------------------------------------------------------
# loss, schedules, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mean", [True, False])
def test_charbonnier_matches(mean):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 5, 5, 7)).astype(np.float32)
    b = a + rng.normal(size=a.shape).astype(np.float32) * 1e-3
    want = jlosses.charbonnier(jnp.asarray(a), jnp.asarray(b), mean=mean)
    got = tlosses.charbonnier(torch.from_numpy(a), torch.from_numpy(b),
                              mean=mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sched", ["constant", "cosine", "cosine_nowarm"])
def test_schedules_match(sched):
    jfn, tfn = {
        "constant": (jconstant_lr(3e-3), constant_lr(3e-3)),
        "cosine": (jcosine(2e-3, 5, 100), cosine_with_warmup(2e-3, 5, 100)),
        "cosine_nowarm": (jcosine(3e-3, 0, 4), cosine_with_warmup(3e-3, 0, 4)),
    }[sched]
    for step in range(0, 110, 3):
        got = tfn(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(
            jnp.asarray(step))), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_scale", [0.01, 30.0])
def test_adamw_matches(decay, grad_scale):
    """Three steps from the same numpy params and gradients (grad_scale 30
    puts the global norm above the clip); params and moments at 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"conv": (6, 4, 3, 3), "dense": (5, 7), "bias": (7,),
              "alpha": (6,)}
    p0 = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
    jp, tp = _jax_tree(p0), {k: torch.from_numpy(v.copy())
                             for k, v in p0.items()}
    jcfg, tcfg = JAdamWConfig(weight_decay=decay), AdamWConfig(
        weight_decay=decay)
    js, ts = jadamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = {k: (rng.normal(size=v) * grad_scale).astype(np.float32)
             for k, v in shapes.items()}
        jp, js, jm = jadamw_update(_jax_tree(g), js, jp, 1e-2, jcfg)
        tp, ts, tm = adamw_update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tp,
                                  torch.tensor(1e-2), tcfg)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()),
                    err_msg=f"{k} step {step}")
        assert int(ts.count) == int(js.count) == step + 1
    if decay:                                   # the ndim >= 2 mask
        plain = adamw_update({k: torch.zeros(v) for k, v in shapes.items()},
                             adamw_init(tp), tp, 1.0, AdamWConfig(
                                 weight_decay=decay, clip_norm=None))[0]
        for k in shapes:
            moved = not torch.equal(plain[k], tp[k])
            assert moved == (len(shapes[k]) >= 2), k


# ---------------------------------------------------------------------------
# training BN and the CNN's training forward
# ---------------------------------------------------------------------------

def test_batchnorm_train_matches():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5, 5, 6)) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(size=6),
         "mean": rng.normal(size=6), "var": rng.uniform(0.5, 2, 6)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want_y, want_p = jnn.batchnorm_train_apply(_jax_tree(p), jnp.asarray(x))
    bn = tnn.BatchNorm(6)
    for k, v in p.items():
        with torch.no_grad():
            getattr(bn, k).copy_(torch.from_numpy(v))
    y = bn.forward_train(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_p[k]), rtol=1e-5,
                                   atol=1e-5)
    assert [n for n, _ in bn.named_buffers()] == ["mean", "var"]
    assert not any(q.requires_grad for q in bn.parameters())


def test_cnn_train_step_loss_and_grads_match(system):
    """The pretraining loss of the batch-stat forward and the gradients of
    every trainable leaf, against jax.value_and_grad of the reference's
    loss; and the BN running stats the forward leaves behind."""
    s = system
    img, labels = s["imgs"][0], s["labels"][0]

    def jloss(p):
        logits, new_p = cnn_forward_train(p, jnp.asarray(img))
        ll = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(
            ll, jnp.asarray(labels)[:, None], 1))
        return loss, new_p

    (want, new_p), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(_jax_tree(s["params"]))
    model = _cnn(s).requires_grad_(True)
    loss, _, grads = ttrainer.cnn_grads(model, torch.from_numpy(img),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    assert len(grads) == 3 * (9 + 1 + 2) + 2      # conv + BN scale, bias
    _assert_grads(grads, jgrads)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), _jax_leaf(new_p, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_inference_forward_is_unchanged_by_training_support(system):
    """edge/cloud without ``train`` use the stored stats, build no graph
    and leave the buffers alone, even on a module being trained."""
    s = system
    model = _cnn(s).requires_grad_(True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    img = torch.from_numpy(s["imgs"][1])
    x_in, z = model.edge(img)
    logits = model.cloud(z)
    assert not (x_in.requires_grad or z.requires_grad or logits.requires_grad)
    _, jz = jax.jit(cnn_edge)(_jax_tree(s["params"]),
                              jnp.asarray(s["imgs"][1]))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the BaF loss with quantization in the loop
# ---------------------------------------------------------------------------

def test_baf_loss_codes_loss_and_grads_match(system):
    s = system
    jparams = _jax_tree(s["params"])
    _, jz = jax.jit(cnn_edge)(jparams, jnp.asarray(s["imgs"][2]))
    z = np.array(jz)
    # the codes: the quantize kernel's plain version on z, exactly the
    # reference's per-example quantization of z[..., sel]
    qp = compute_quant_params(jz[..., jnp.asarray(s["sel"])], BITS,
                              per_example=True)
    jcodes = np.asarray(quantize(jz[..., jnp.asarray(s["sel"])], qp))
    b, h, w, p = z.shape
    tsel = torch.as_tensor(s["sel"].astype(np.int32))
    codes, mins, maxs = tquant.quantize_fused(
        torch.from_numpy(z).view(b, h * w, p), BITS, tsel,
        order=tquant.channel_order(tsel))
    np.testing.assert_array_equal(codes.view(b, h, w, C).numpy(), jcodes)
    np.testing.assert_array_equal(mins.numpy().view(np.uint16),
                                  np.asarray(qp.mins).reshape(b, C)
                                  .view(np.uint16))
    np.testing.assert_array_equal(maxs.numpy().view(np.uint16),
                                  np.asarray(qp.maxs).reshape(b, C)
                                  .view(np.uint16))

    jloss_fn = jtrainer.make_baf_loss(jparams, s["sel"], BITS)
    want, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        _jax_tree(s["baf"]), jz)
    model, baf = _cnn(s), _baf(s).requires_grad_(True)
    loss_fn = ttrainer.make_baf_loss(model, s["sel"], BITS, device="cpu")
    loss = loss_fn(baf, torch.from_numpy(z))
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    _assert_grads({n: q.grad for n, q in baf.named_parameters()}, jgrads)
    assert all(q.grad is None for q in model.parameters())


# ---------------------------------------------------------------------------
# the trainers over a few steps
# ---------------------------------------------------------------------------

def _patch_both(monkeypatch, s, batches):
    """Both packages see the same numpy batches and the bridged weights."""
    def jit_(cfg, seed=0, start_step=0):
        return iter([(jnp.asarray(i), jnp.asarray(lb, jnp.int32))
                     for i, lb in batches])

    def tit(cfg, seed=0, start_step=0, *, device=None):
        return iter([(torch.from_numpy(i), torch.from_numpy(lb))
                     for i, lb in batches])

    monkeypatch.setattr(jtrainer, "shapes_batch_iterator", jit_)
    monkeypatch.setattr(ttrainer, "shapes_batch_iterator", tit)
    monkeypatch.setattr(jtrainer, "init_cnn",
                        lambda key, cfg: _jax_tree(s["params"]))
    monkeypatch.setattr(jtrainer, "init_baf_conv",
                        lambda key, cfg: _jax_tree(s["baf"]))
    monkeypatch.setattr(ttrainer, "CNN",
                        lambda cfg, seed=0, device=None: _cnn(s))
    monkeypatch.setattr(ttrainer, "BaFConv",
                        lambda cfg, seed=0, device=None: _baf(s))


def test_pretrain_cnn_losses_match(system, monkeypatch):
    s = system
    _patch_both(monkeypatch, s, list(zip(s["imgs"], s["labels"])))
    _, jhist = jtrainer.pretrain_cnn(JCFG, JDATA, steps=3, log_every=1,
                                     verbose=False)
    model, hist = ttrainer.pretrain_cnn(TCFG, TDATA, steps=3, log_every=1,
                                        verbose=False, device="cpu")
    assert [h[0] for h in hist] == [h[0] for h in jhist] == [0, 1, 2]
    np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in jhist],
                               rtol=1e-3, atol=1e-3)
    assert not any(q.requires_grad for q in model.parameters())


def test_train_baf_losses_match_and_the_cnn_stays_frozen(system, monkeypatch):
    s = system
    _patch_both(monkeypatch, s, list(zip(s["imgs"], s["labels"])))
    jres = jtrainer.train_baf(_jax_tree(s["params"]), JCFG, JDATA, s["sel"],
                              bits=BITS, hidden=HIDDEN, steps=3, log_every=1,
                              verbose=False)
    model = _cnn(s)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = ttrainer.train_baf(model, TCFG, TDATA, s["sel"], bits=BITS,
                             hidden=HIDDEN, steps=3, log_every=1,
                             verbose=False, device="cpu")
    np.testing.assert_allclose([v for _, v in res.losses],
                               [v for _, v in jres.losses], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(res.sel_idx, jres.sel_idx)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(q.grad is None for q in model.parameters())
    assert not any(q.requires_grad for q in res.baf_params.parameters())


def test_channel_order_runs_on_the_models_device(system):
    s = system
    model = _cnn(s)
    with pytest.raises(ValueError, match="lives on"):
        ttrainer.compute_channel_order(model, TDATA, batches=1,
                                       device="meta")
    res = ttrainer.compute_channel_order(model, TDATA, batches=2,
                                         device="cpu")
    assert sorted(res.order.tolist()) == list(range(TCFG.split_p))
    assert 0.0 <= ttrainer.eval_cnn(model, TDATA, batches=2,
                                    device="cpu") <= 1.0


@pytest.mark.parametrize("entry", ["pretrain_cnn", "train_baf",
                                   "compute_channel_order", "eval_cnn",
                                   "make_baf_loss", "shapes"])
def test_entry_points_default_to_the_card(system, entry):
    """``device=None`` is the card: without one, each entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would run on it")
    model = _cnn(system)
    calls = {
        "pretrain_cnn": lambda: ttrainer.pretrain_cnn(TCFG, TDATA, steps=1),
        "train_baf": lambda: ttrainer.train_baf(model, TCFG, TDATA,
                                                system["sel"], steps=1),
        "compute_channel_order": lambda: ttrainer.compute_channel_order(
            model, TDATA),
        "eval_cnn": lambda: ttrainer.eval_cnn(model, TDATA),
        "make_baf_loss": lambda: ttrainer.make_baf_loss(model,
                                                        system["sel"], 8),
        "shapes": lambda: next(shapes_batch_iterator(TDATA)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _baf_run(s, steps, ckpt_dir=None, stop_at=None):
    """A BaF training loop on the CPU with the port's step; with
    ``ckpt_dir`` it saves at ``stop_at`` and restarts from there (a new
    predictor, optimizer and data stream restored from the checkpoint)."""
    model = _cnn(s)
    loss_fn = ttrainer.make_baf_loss(model, s["sel"], BITS, device="cpu")
    sched = cosine_with_warmup(2e-3, 1, steps)
    ocfg = AdamWConfig(weight_decay=0.0)

    def start(step):
        baf = _baf(s).requires_grad_(True)
        return baf, adamw_init(ttrainer.trainable(baf)), \
            shapes_batch_iterator(TDATA, seed=3, start_step=step,
                                  device="cpu")

    baf, opt, it = start(0)
    losses = []
    for step in range(steps):
        if step == stop_at:
            tckpt.save(ckpt_dir, step, {"params": ttrainer.trainable(baf),
                                        "opt": opt})
            baf, opt, it = start(step)
            like = {"params": ttrainer.trainable(baf), "opt": opt}
            tree, got = tckpt.restore(ckpt_dir, like)
            assert got == step
            with torch.no_grad():
                for k, q in ttrainer.trainable(baf).items():
                    q.copy_(tree["params"][k])
            opt = tree["opt"]
        img, _ = next(it)
        opt, loss = ttrainer.baf_step(baf, opt, sched(step),
                                      model.edge(img)[1], loss_fn, ocfg)
        losses.append(loss)
    return baf, opt, losses


def test_checkpoint_resume_is_bit_identical(system, tmp_path):
    s = system
    baf, opt, losses = _baf_run(s, 4)
    baf2, opt2, losses2 = _baf_run(s, 4, str(tmp_path), stop_at=2)
    for a, b in zip(losses, losses2):
        assert torch.equal(a, b)
    for (k, a), (_, b) in zip(baf.state_dict().items(),
                              baf2.state_dict().items()):
        assert torch.equal(a, b), k
    assert int(opt.count) == int(opt2.count) == 4
    for k in opt.mu:
        assert torch.equal(opt.mu[k], opt2.mu[k])
        assert torch.equal(opt.nu[k], opt2.nu[k])


def test_checkpoint_writes_are_atomic_and_retained(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    assert tckpt.restore(d, {"w": torch.zeros(2)}) == (None, None)
    os.makedirs(d)
    assert tckpt.restore(d, {"w": torch.zeros(2)}) == (None, None)
    for step in range(5):
        tckpt.save(d, step, {"w": torch.full((2,), float(step)),
                             "n": np.arange(3)})
    assert tckpt.latest_step(d) == 4

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(d, 9, {"w": torch.zeros(2), "n": np.arange(3)})
    monkeypatch.undo()
    assert tckpt.latest_step(d) == 4
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]
    tckpt.retain_last(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_3", "step_4"]
    tree, step = tckpt.restore(d, {"w": torch.zeros(2), "n": np.zeros(3,
                                                                    np.int64)})
    assert step == 4 and torch.equal(tree["w"], torch.full((2,), 4.0))
    np.testing.assert_array_equal(tree["n"], np.arange(3))
    tree, step = tckpt.restore(d, {"w": torch.zeros(2), "n": np.zeros(3)},
                               step=3)
    assert step == 3 and float(tree["w"][0]) == 3.0
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, {"w": torch.zeros(2)})


def test_jax_checkpoint_restores_into_the_port(system, tmp_path):
    """A checkpoint that the JAX package wrote of BaF params restores here
    as numpy leaves; bridged, it predicts what the JAX params predict."""
    s = system
    jbaf = _jax_tree(s["baf"])
    jckpt.save(str(tmp_path), 7, jbaf)
    like = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), s["baf"])
    tree, step = tckpt.restore(str(tmp_path), like)
    assert step == 7
    baf = baf_from_jax(tree, BaFConvConfig(c=C, q=TCFG.split_q,
                                           hidden=HIDDEN), device="cpu")
    rng = np.random.default_rng(11)
    z_hat = rng.normal(size=(2, 4, 4, C)).astype(np.float32)
    jparams = _jax_tree(s["params"])
    want = jax_baf_predict(jbaf, jparams["split"]["conv"],
                           jparams["split"]["bn"],
                           jnp.asarray(s["sel"], jnp.int32),
                           jnp.asarray(z_hat))
    with torch.no_grad():
        got = baf_conv_predict(baf, _cnn(s).split,
                               torch.as_tensor(s["sel"]),
                               torch.from_numpy(z_hat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_split_inference_launcher_runs_on_the_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.split_inference --fast --device cpu``
    end to end, cut to a tiny CNN and two steps of each trainer: it
    pretrains, selects, trains a BaF for each C of the sweep and serves
    through the wire."""
    from repro_torch.launch import split_inference as launcher

    def short(fn):
        return lambda *a, **k: fn(*a, **{**k, "steps": 2})

    monkeypatch.setattr(launcher, "smoke_config",
                        lambda: TCFG._replace(input_size=64))
    monkeypatch.setattr(launcher, "pretrain_cnn",
                        short(ttrainer.pretrain_cnn))
    monkeypatch.setattr(launcher, "train_baf", short(ttrainer.train_baf))
    assert launcher.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines()
            if ln.split() and ln.split()[0] in {"4", "8", "16", "32"}]
    assert [r[0] for r in rows] == ["4", "8", "16", "32"]  # C <= P = 32
    assert all(0.0 <= float(r[1]) <= 1.0 and int(r[3]) > 0 for r in rows)
