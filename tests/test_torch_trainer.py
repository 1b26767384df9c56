"""The port's LM training step against the JAX package's, at smoke scale in
float32; checkpoints, the fault-tolerance harness and the launchers.

``make_train_step`` over 3 steps with 1 and 2 microbatches, both packages
fed the same numpy batches and the same weights (``bridge.
master_from_jax``): the losses agree at 1e-3 (Adam's first step is about
lr * sign(g), so trajectories are held by their losses). A checkpoint taken
mid-run and restored continues the trajectory bit for bit. The watchdog
raises on an overrun and SIGTERM sets the preemption flag. The launchers
are in ``tests/test_torch_train_launch.py``.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.lm import init_lm as jax_init_lm
from repro.train import trainer as jtrainer
from repro_torch import configs
from repro_torch.bridge import master_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (PreemptionFlag, StepDeadlineExceeded,
                                     Watchdog)
from repro_torch.train.trainer import (TrainConfig, TrainState, init_params,
                                       init_train_state, make_train_step,
                                       stacked_decay)

B, S, STEPS = 4, 32, 3
SCHEDULE = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10)


def setup(arch, seed=1):
    jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
    tcfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
    init = jax_init_encdec if jcfg.family == "audio" else jax_init_lm
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(STEPS + 2):
        tokens = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if jcfg.family == "audio":
            b["audio_embeds"] = rng.normal(
                size=(B, 24, jcfg.d_model)).astype(np.float32)
        batches.append(b)
    return jcfg, tcfg, params, batches


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_losses(jcfg, params, batches, mb):
    tcfg = jtrainer.TrainConfig(num_microbatches=mb, **SCHEDULE)
    state = jtrainer.init_train_state(jax.tree.map(jnp.asarray, params), tcfg)
    step = jax.jit(jtrainer.make_train_step(jcfg, tcfg))
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def torch_run(tcfg, state, batches, mb):
    step = make_train_step(tcfg, TrainConfig(num_microbatches=mb, **SCHEDULE))
    out = []
    for b in batches:
        state, m = step(state, torch_batch(b))
        out.append(float(m["loss"]))
    return state, out


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2_7b", "olmoe_1b_7b", "rwkv6_3b",
                                  "zamba2_1p2b", "whisper_tiny"])
def test_train_step_losses_match_jax(arch, mb):
    jcfg, tcfg, params, batches = setup(arch)
    want = jax_losses(jcfg, params, batches[:STEPS], mb)
    state = init_train_state(master_from_jax(params, tcfg, device="cpu"),
                             TrainConfig(num_microbatches=mb))
    state, got = torch_run(tcfg, state, batches[:STEPS], mb)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert int(state.step) == STEPS and int(state.opt.count) == STEPS
    assert all(p.dtype == torch.float32 for p in state.params.values())


def test_microbatches_must_divide_the_batch():
    _, tcfg, params, batches = setup("qwen2_7b")
    state = init_train_state(master_from_jax(params, tcfg, device="cpu"),
                             TrainConfig())
    step = make_train_step(tcfg, TrainConfig(num_microbatches=3))
    with pytest.raises(ValueError, match="multiple of 3 microbatches"):
        step(state, torch_batch(batches[0]))


def test_decay_mask_follows_the_stacked_layout():
    """A layer's norm scale is (L, D) in the reference, so its default
    mask decays it; the final norm's (D,) is not decayed."""
    v = torch.ones(8)
    assert stacked_decay("layers.0.ln1.scale", v)
    assert stacked_decay("dec_layers.1.attn.bq", v)
    assert not stacked_decay("final_norm.scale", v)
    assert not stacked_decay("shared.ln1.scale", v)
    assert stacked_decay("embed", torch.ones(4, 8))


def test_multi_pod_compression_is_not_ported():
    """The multi-pod exchange is ported now (tests/test_torch_trainer_
    multipod.py); without the mesh whose pod axis it runs over it raises."""
    tcfg = configs.get_smoke_config("qwen2_7b")
    with pytest.raises(ValueError, match="needs the mesh"):
        make_train_step(tcfg, TrainConfig(grad_compress_bits=8),
                        multi_pod=True)
    # in one process the field is ignored, as in the reference; the
    # error-feedback residuals are still kept beside the weights
    state = init_train_state(init_params(tcfg, device="cpu"),
                             TrainConfig(grad_compress_bits=8))
    assert state.ef.keys() == state.params.keys()
    make_train_step(tcfg, TrainConfig(grad_compress_bits=8))


def test_init_params_are_the_models_float32_draws():
    from repro_torch.models.lm import init_lm
    cfg = configs.get_smoke_config("rwkv6_3b")
    params = init_params(cfg, seed=4, device="cpu")
    model = init_lm(cfg, seed=4, device="cpu")
    assert params.keys() == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        assert params[name].dtype == torch.float32
        assert params[name].requires_grad
        assert torch.equal(params[name].to(p.dtype), p), name


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a restore into a
    fresh state and 2 more: the same losses and the same final weights,
    moments and step, bit for bit; requires_grad survives the restore."""
    _, tcfg, params, batches = setup("qwen2_7b")
    t = TrainConfig(num_microbatches=2)
    fresh = lambda: init_train_state(                       # noqa: E731
        master_from_jax(params, tcfg, device="cpu"), t)
    straight, losses = torch_run(tcfg, fresh(), batches[:4], 2)
    half, first = torch_run(tcfg, fresh(), batches[:2], 2)
    ckpt.save(str(tmp_path), 2, half)
    restored, at = ckpt.restore(str(tmp_path), like=fresh())
    assert at == 2 and int(restored.step) == 2
    assert isinstance(restored, TrainState) and restored.ef is None
    assert all(p.requires_grad for p in restored.params.values())
    resumed, second = torch_run(tcfg, restored, batches[2:4], 2)
    assert first + second == losses
    for a, b in ((straight.params, resumed.params),
                 (straight.opt.mu, resumed.opt.mu),
                 (straight.opt.nu, resumed.opt.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(straight.step, resumed.step)
    assert torch.equal(straight.opt.count, resumed.opt.count)


def test_watchdog_raises_on_an_overrun():
    wd = Watchdog(factor=2.0, min_floor=0.05, history=[0.01])
    assert wd.guard(lambda x: x + 1, 1) == 2
    with pytest.raises(StepDeadlineExceeded):
        wd.guard(time.sleep, 2.0)


def test_preemption_flag_catches_sigterm():
    old = signal.getsignal(signal.SIGTERM)
    try:
        flag = PreemptionFlag().install()
        assert not flag.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert flag.triggered
    finally:
        signal.signal(signal.SIGTERM, old)
