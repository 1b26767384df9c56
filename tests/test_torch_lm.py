"""The port's LM serving path against the JAX package, at smoke scale.

The dense GQA smoke configs (qwen2-7b, starcoder2-15b with GELU and
LayerNorm, nemotron-4-15b with squared ReLU, qwen2-72b) and rwkv6-3b
(RWKV-6), 2 layers each. Weights
come from the JAX ``init_lm``; its zero biases, zero token-shift mixes and
unit norm scales would hide mistakes, so they are overwritten with numpy
draws before ``bridge.lm_from_jax`` carries them across. The JAX side runs
under its Pallas attention and scan backends (interpret mode) at S = 128,
so its kernels really run. Checked: prefill logits, three decode steps
(logits, KV caches, RWKV states) and the rwkv long ingest (last logits,
final states), at 1e-4 with ``cfg.dtype = float32`` and 3e-2 in bf16 (the
two frameworks round bf16 matmuls at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import base as jax_base
from repro.configs.base import param_count_dense as jax_param_count
from repro.models import attention as JA
from repro.models import linear_attention as JL
from repro.models.lm import init_decode_cache as jax_init_cache
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import lm_decode_step as jax_decode_step
from repro.serve.engine import make_long_ingest as jax_long_ingest
from repro.serve.engine import make_prefill_step as jax_prefill_step
from repro_torch import configs
from repro_torch.bridge import lm_from_jax
from repro_torch.configs import base as tbase
from repro_torch.configs.base import param_count_dense
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import LM, init_decode_cache, lm_forward
from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                      make_prefill_step)

ARCHS = ["qwen2_7b", "rwkv6_3b", "starcoder2_15b", "nemotron4_15b",
         "qwen2_72b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
S = 128


@pytest.fixture
def pallas_backends():
    JA.set_backend("pallas")
    JL.set_backend("pallas")
    yield
    JA.set_backend(None)
    JL.set_backend(None)


def _randomize(params, rng):
    """Random norm scales and biases, QKV biases and token-shift mixes."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        name = path[-1]
        if name in ("scale",):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "bq", "bk", "bv"):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if name in ("mu_x", "mu_base", "cm_mu_k", "cm_mu_r"):
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        if name == "w0":
            return (rng.normal(size=a.shape) * 0.5 - 1.0).astype(np.float32)
        return a
    return walk(params)


def _system(arch, dtype_name):
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = jax_smoke_config(arch).with_(dtype=jdt)
    tcfg = configs.get_smoke_config(arch).with_(dtype=tdt)
    params = _randomize(jax_init_lm(jax.random.PRNGKey(0), jcfg),
                        np.random.default_rng(1))
    model = lm_from_jax(params, tcfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (2, S))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, params),
                model=model, tokens=tokens, tol=tol)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pallas_backends, arch, dtype):
    s = _system(arch, dtype)
    want = jax_prefill_step(s["jcfg"])(s["jp"],
                                       {"tokens": jnp.asarray(s["tokens"])})
    got = make_prefill_step(s["tcfg"])(s["model"],
                                       {"tokens": torch.from_numpy(s["tokens"])})
    assert got.shape == (2, S, s["jcfg"].vocab)
    _close(got, want, s["tol"])

    jc = jax_init_cache(s["jcfg"], 2, 8)
    tc = init_decode_cache(s["tcfg"], 2, 8, device="cpu")
    step = make_decode_step(s["tcfg"])
    for t in range(3):
        tok = s["tokens"][:, t]
        jl, jc = jax_decode_step(s["jp"], s["jcfg"], jc,
                                 jnp.asarray(tok, jnp.int32))
        tl, tc = step(s["model"], tc, torch.from_numpy(tok))
        _close(tl, jl, s["tol"])
    if s["tcfg"].family == "dense":
        for i, kv in enumerate(tc.kv):
            assert kv.length == 3
            _close(kv.k, jc.kv.k[i], s["tol"])
            _close(kv.v, jc.kv.v[i], s["tol"])
    else:
        for i, st in enumerate(tc.rwkv):
            _close(st.wkv, jc.rwkv.wkv[i], s["tol"])
            _close(st.last_tm, jc.rwkv.last_tm[i], s["tol"])
            _close(st.last_cm, jc.rwkv.last_cm[i], s["tol"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_long_ingest_matches_jax(pallas_backends, dtype):
    s = _system("rwkv6_3b", dtype)
    jl, jst = jax_long_ingest(s["jcfg"], block=32)(s["jp"],
                                                   jnp.asarray(s["tokens"]))
    tl, tst = make_long_ingest(s["tcfg"], block=32)(
        s["model"], torch.from_numpy(s["tokens"]))
    _close(tl, jl, s["tol"])
    assert tst.block_idx == int(jst.block_idx) == S // 32
    for i, st in enumerate(tst.layer_states):
        _close(st.wkv, jst.layer_states.wkv[i], s["tol"])
        _close(st.last_tm, jst.layer_states.last_tm[i], s["tol"])
        _close(st.last_cm, jst.layer_states.last_cm[i], s["tol"])


def test_ingest_chains_like_one_prefill():
    """Segment chaining is exact in the reference: the ingest's last logits
    equal the last position of one prefill over the same tokens."""
    s = _system("rwkv6_3b", "float32")
    toks = torch.from_numpy(s["tokens"])
    full = make_prefill_step(s["tcfg"])(s["model"], {"tokens": toks})
    last, _ = make_long_ingest(s["tcfg"], block=32)(s["model"], toks)
    torch.testing.assert_close(last, full[:, -1], atol=1e-5, rtol=1e-5)


def test_blocked_attention_lm_matches_flash_lm():
    s = _system("qwen2_7b", "float32")
    toks = torch.from_numpy(s["tokens"])
    prefill = make_prefill_step(s["tcfg"])
    torch.testing.assert_close(
        lm_forward(s["model"], tokens=toks, attention="blocked")[0],
        prefill(s["model"], {"tokens": toks}), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get_j, get_t in ((jax_get_config, configs.get_config),
                         (jax_smoke_config, configs.get_smoke_config)):
        jcfg, tcfg = get_j(arch), get_t(arch)
        for name in ("name", "family", "n_layers", "d_model", "n_heads",
                     "n_kv_heads", "d_ff", "vocab", "hd", "act", "qkv_bias",
                     "rope_theta", "norm", "tie_embeddings"):
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert param_count_dense(tcfg) == jax_param_count(jcfg)
    assert configs.get_config(arch.replace("_", "-")).name == \
        jax_get_config(arch).name


def _port_config(jcfg):
    """The JAX config's fields in the port's dataclasses, torch dtypes."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in (("moe", tbase.MoEConfig), ("ssm", tbase.SSMConfig),
                      ("hybrid", tbase.HybridConfig),
                      ("encdec", tbase.EncDecConfig)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    kw.update(dtype=torch.bfloat16, param_dtype=torch.float32)
    return tbase.ArchConfig(**kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax_for_every_arch(arch):
    """The port's count formulas (MoE, hybrid and encoder-decoder cases
    included) on every published config."""
    jcfg = jax_get_config(arch)
    tcfg = _port_config(jcfg)
    for fn in ("param_count_dense", "active_param_count", "total_param_count"):
        assert getattr(tbase, fn)(tcfg) == getattr(jax_base, fn)(jcfg), fn


def test_full_configs_have_the_published_sizes():
    qwen, rwkv = configs.get_config("qwen2-7b"), configs.get_config("rwkv6-3b")
    assert qwen.dtype == torch.bfloat16 and qwen.param_dtype == torch.float32
    assert round(param_count_dense(qwen) / 1e9, 1) == 7.6
    assert round(param_count_dense(rwkv) / 1e9, 1) == 3.1
    assert qwen.n_heads // qwen.n_kv_heads == 7 and qwen.hd == 128
    assert rwkv.ssm.chunk == 16 and rwkv.d_model // rwkv.ssm.head_dim == 40


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 step 9"):
        configs.get_config("olmoe-1b-7b")
    cfg = configs.get_smoke_config("qwen2_7b").with_(family="moe")
    with pytest.raises(NotImplementedError, match="Queue 1 step 9"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="sub-quadratic"):
        make_long_ingest(configs.get_smoke_config("qwen2_7b"))
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


def test_init_draws_the_jax_distributions():
    cfg = configs.get_smoke_config("rwkv6_3b").with_(dtype=torch.float32)
    m = LM(cfg, seed=0, device="cpu")
    blk = m.layers[0]
    assert torch.equal(blk.w0, torch.full_like(blk.w0, -1.0))
    assert torch.equal(blk.cm_mu_k, torch.full_like(blk.cm_mu_k, 0.5))
    assert float(blk.mu_base.abs().sum()) == 0.0
    assert torch.equal(m.final_norm.scale, torch.ones_like(m.final_norm.scale))
    assert abs(float(blk.wr.std()) - 0.02) < 0.002
    assert abs(float(blk.u.std()) - 0.1) < 0.02
    assert torch.equal(LM(cfg, seed=0, device="cpu").embed, m.embed)


def test_serve_launcher_runs_on_the_cpu(capsys):
    assert launcher.main(["--arch", "qwen2-7b", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3",
                          "--device", "cpu"]) == 0
    assert launcher.main(["--arch", "rwkv6-3b", "--batch", "2",
                          "--long", "64", "--block", "32",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[prefill] 8 tokens x2" in out and "[decode] 3 tokens x2" in out
    assert "[long] ingested 64 tokens x2 in blocks of 32" in out
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen2-7b", "--long", "64", "--device",
                       "cpu"])
