"""The port's LM serving path against the JAX package, at smoke scale.

The dense GQA smoke configs (qwen2-7b, starcoder2-15b with GELU and
LayerNorm, nemotron-4-15b with squared ReLU, qwen2-72b), rwkv6-3b
(RWKV-6), the MoE configs (olmoe-1b-7b; arctic-480b with its dense
residual), zamba2-1.2b (Mamba-2 layers and the shared attention block) and
pixtral-12b (prefill from embeddings, decode from tokens), 2-4 layers
each. Weights come from the JAX ``init_lm``; its zero biases, zero
token-shift mixes, constant Mamba-2 leaves and unit norm scales would hide
mistakes, so they are overwritten with numpy draws before
``bridge.lm_from_jax`` carries them across. The JAX side runs under its
Pallas attention and scan backends (interpret mode) at S = 128, so its
kernels really run. Checked: prefill logits, three decode steps (logits,
KV caches, RWKV and Mamba-2 states, the shared block's KV caches) and the
rwkv and zamba2 long ingests (last logits, final states, the windowed K/V
carry), at 1e-4 with ``cfg.dtype = float32`` and 3e-2 in bf16 (the two
frameworks round bf16 matmuls at different places). Routing is
discontinuous, so the MoE models are held whole in float32 only;
``tests/test_torch_moe.py`` holds the layer in bf16 on identical inputs.
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
from repro.models import moe as JM
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
from repro_torch.models import attention as TA
from repro_torch.models.moe import moe_apply
from repro_torch.models.encdec import init_encdec
from repro_torch.models.lm import (LM, init_decode_cache, lm_forward,
                                   segment_bounds)
from repro_torch.serve.engine import (decode_cache_from_ingest,
                                      make_decode_step, make_long_ingest,
                                      make_prefill_step)

ARCHS = ["qwen2_7b", "rwkv6_3b", "starcoder2_15b", "nemotron4_15b",
         "qwen2_72b", "olmoe_1b_7b", "arctic_480b", "zamba2_1p2b",
         "pixtral_12b"]
MOE_ARCHS = ("olmoe_1b_7b", "arctic_480b")
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
        if name in ("conv_b", "A_log"):
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-3.0, -1.0, a.shape).astype(np.float32)
        if name == "D":
            return (1.0 + rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return a
    return walk(params)


def _system(arch, dtype_name):
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = jax_smoke_config(arch).with_(dtype=jdt)
    tcfg = configs.get_smoke_config(arch).with_(dtype=tdt)
    params = _randomize(jax_init_lm(jax.random.PRNGKey(0), jcfg),
                        np.random.default_rng(1))
    model = lm_from_jax(params, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (2, S))
    # vlm prompts: precomputed (vision + text) embeddings
    embeds = (rng.normal(size=(2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, params),
                model=model, tokens=tokens, embeds=embeds, tol=tol)


def _prompt(s, to):
    """The prefill batch: tokens, or embeddings where the arch takes them."""
    if s["tcfg"].embed_inputs:
        return {"tokens": to(s["tokens"])}
    return {"embeds": to(s["embeds"])}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pallas_backends, arch, dtype):
    if arch in MOE_ARCHS and dtype == "bfloat16":
        # whole MoE models route discontinuously: held in float32; in bf16
        # each layer on the same input in both packages
        return _moe_bf16_layers_match_jax(arch)
    s = _system(arch, dtype)
    want = jax_prefill_step(s["jcfg"])(s["jp"], _prompt(s, jnp.asarray))
    got = make_prefill_step(s["tcfg"])(s["model"],
                                       _prompt(s, torch.from_numpy))
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
    family = s["tcfg"].family
    if family == "ssm":
        for i, st in enumerate(tc.rwkv):
            _close(st.wkv, jc.rwkv.wkv[i], s["tol"])
            _close(st.last_tm, jc.rwkv.last_tm[i], s["tol"])
            _close(st.last_cm, jc.rwkv.last_cm[i], s["tol"])
        return
    if family == "hybrid":
        for i, st in enumerate(tc.ssm):
            _close(st.ssm, jc.ssm.ssm[i], s["tol"])
            _close(st.conv, jc.ssm.conv[i], s["tol"])
        kvs, jkv = tc.shared_kv, jc.shared_kv
        assert len(kvs) == len(range(0, s["tcfg"].n_layers,
                                     s["tcfg"].hybrid.shared_attn_every))
    else:
        kvs, jkv = tc.kv, jc.kv
    for i, kv in enumerate(kvs):
        assert kv.length == 3
        _close(kv.k, jkv.k[i], s["tol"])
        _close(kv.v, jkv.v[i], s["tol"])


def _moe_bf16_layers_match_jax(arch):
    """bf16 MoE, layer by layer: each layer's MoE on the port's own hidden
    state (ln2 of the residual after attention) against the JAX
    ``moe_apply`` on the same bf16 input, 3e-2."""
    s = _system(arch, "bfloat16")
    cfg, m = s["tcfg"], s["model"]
    x = m.embed[torch.from_numpy(s["tokens"])].to(cfg.dtype)
    for i, lp in enumerate(m.layers):
        x = x + TA.attention_apply(lp.attn, lp.ln1(x), n_heads=cfg.n_heads,
                                   n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                                   rope_theta=cfg.rope_theta)
        xn = lp.ln2(x)
        y, aux = moe_apply(lp.moe, xn, cfg.moe)
        jp = jax.tree.map(lambda a: a[i], s["jp"]["layers"]["moe"])
        jy, jaux = JM.moe_apply(jp, jnp.asarray(xn.float().numpy())
                                .astype(jnp.bfloat16), s["jcfg"].moe,
                                s["jcfg"].act, s["jcfg"].d_ff)
        _close(y, jy, s["tol"])
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        x = x + y


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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hybrid_long_ingest_matches_jax(pallas_backends, dtype):
    """zamba2 in blocks of 16 (the shared block's window, as the launcher
    sets ``attn_window_long`` for ``--long``): last logits, the Mamba-2
    states and the shared block's windowed K/V carry per segment."""
    s = _system("zamba2_1p2b", dtype)
    jcfg = s["jcfg"].with_(hybrid=dataclasses.replace(
        s["jcfg"].hybrid, attn_window_long=16))
    tcfg = s["tcfg"].with_(hybrid=dataclasses.replace(
        s["tcfg"].hybrid, attn_window_long=16))
    jl, jst = jax_long_ingest(jcfg, block=16)(s["jp"],
                                              jnp.asarray(s["tokens"]))
    tl, tst = make_long_ingest(tcfg, block=16)(
        s["model"], torch.from_numpy(s["tokens"]))
    _close(tl, jl, s["tol"])
    assert tst.block_idx == int(jst.block_idx) == S // 16
    for i, st in enumerate(tst.layer_states):
        _close(st.ssm, jst.layer_states.ssm[i], s["tol"])
        _close(st.conv, jst.layer_states.conv[i], s["tol"])
    assert len(tst.shared_k) == jst.shared_k.shape[0] == 2
    for seg in range(2):
        _close(tst.shared_k[seg], jst.shared_k[seg], s["tol"])
        _close(tst.shared_v[seg], jst.shared_v[seg], s["tol"])


def test_hybrid_ingest_equals_a_windowed_prefill():
    """The ingest's shared block sees the last ``block`` positions: its
    last logits equal a prefill's with ``window=block`` (and not a prefill
    without a window, which attends to everything)."""
    s = _system("zamba2_1p2b", "float32")
    toks = torch.from_numpy(s["tokens"])
    last, _ = make_long_ingest(s["tcfg"], block=16)(s["model"], toks)
    windowed = lm_forward(s["model"], tokens=toks, window=16)[0][:, -1]
    full = lm_forward(s["model"], tokens=toks)[0][:, -1]
    torch.testing.assert_close(last, windowed, atol=1e-5, rtol=1e-5)
    assert float((last - full).abs().max()) > 1e-3


def test_decode_continues_the_hybrid_ingest():
    """Decode from the ingest's states (``decode_cache_from_ingest``): the
    shared block attends the last ``block`` positions, so each step equals
    a windowed prefill over the longer sequence at its position."""
    s = _system("zamba2_1p2b", "float32")
    toks = torch.from_numpy(np.concatenate(
        [s["tokens"], s["tokens"][:, :8]], axis=1))
    last, st = make_long_ingest(s["tcfg"], block=16)(s["model"], toks[:, :S])
    cache = decode_cache_from_ingest(s["tcfg"], st, 3)
    assert [kv.start for kv in cache.shared_kv] == [S - 15] * 2
    full = lm_forward(s["model"], tokens=toks, window=16)[0]
    torch.testing.assert_close(last, full[:, S - 1], atol=1e-5, rtol=1e-5)
    step = make_decode_step(s["tcfg"])
    for t in range(3):
        logits, cache = step(s["model"], cache, toks[:, S + t])
        torch.testing.assert_close(logits, full[:, S + t], atol=1e-5,
                                   rtol=1e-5)
    rw = _system("rwkv6_3b", "float32")
    _, rst = make_long_ingest(rw["tcfg"], block=32)(
        rw["model"], torch.from_numpy(rw["tokens"]))
    assert decode_cache_from_ingest(rw["tcfg"], rst, 3).rwkv == \
        rst.layer_states


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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    for get_j, get_t in ((jax_get_config, configs.get_config),
                         (jax_smoke_config, configs.get_smoke_config)):
        jcfg, tcfg = get_j(arch), get_t(arch)
        for name in ("name", "family", "n_layers", "d_model", "n_heads",
                     "n_kv_heads", "d_ff", "vocab", "hd", "act", "qkv_bias",
                     "rope_theta", "norm", "tie_embeddings"):
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert param_count_dense(tcfg) == jax_param_count(jcfg)
        for sub in ("moe", "ssm", "hybrid", "encdec"):
            a, b = getattr(tcfg, sub), getattr(jcfg, sub)
            assert (a is None) == (b is None), sub
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), sub
        assert tcfg.embed_inputs == jcfg.embed_inputs
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
    """Every arch of the zoo is ported now: each builds and runs one smoke
    prefill on the CPU. Still refused: an unknown arch (KeyError) and a
    long ingest of a dense arch (ValueError)."""
    assert set(configs.PORTED) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        cfg = configs.get_smoke_config(arch)
        toks = torch.zeros((1, 8), dtype=torch.long)
        if cfg.family == "audio":
            model = init_encdec(cfg, device="cpu")
            batch = {"audio_embeds": torch.zeros((1, 16, cfg.d_model)),
                     "tokens": toks}
        else:
            model = LM(cfg, device="cpu")
            batch = ({"tokens": toks} if cfg.embed_inputs else
                     {"embeds": torch.zeros((1, 8, cfg.d_model))})
        logits = make_prefill_step(cfg)(model, batch)
        assert logits.shape == (1, 8, cfg.vocab), arch
        assert bool(torch.isfinite(logits.float()).all()), arch
    with pytest.raises(ValueError, match="sub-quadratic"):
        make_long_ingest(configs.get_smoke_config("qwen2_7b"))
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
    with pytest.raises(ValueError, match="encoder-decoder"):
        LM(configs.get_smoke_config("whisper_tiny"), device="cpu")


def test_new_full_configs_have_the_published_sizes():
    olmoe, arctic = configs.get_config("olmoe-1b-7b"), \
        configs.get_config("arctic-480b")
    zamba, pixtral = configs.get_config("zamba2-1.2b"), \
        configs.get_config("pixtral-12b")
    assert round(tbase.total_param_count(olmoe) / 1e9, 2) == 6.92
    assert round(tbase.total_param_count(arctic) / 1e9, 2) == 476.85
    assert round(param_count_dense(pixtral) / 1e9, 2) == 12.25
    assert (olmoe.moe.num_experts, olmoe.moe.top_k) == (64, 8)
    assert (arctic.moe.num_experts, arctic.moe.top_k) == (128, 2)
    assert arctic.moe.dense_residual and not olmoe.moe.dense_residual
    assert zamba.ssm.chunk == 128 and zamba.ssm.state_dim == 64
    assert len(segment_bounds(zamba)) == 7
    assert segment_bounds(zamba)[-1] == (36, 38)
    assert not pixtral.embed_inputs and pixtral.family == "vlm"
    whisper = configs.get_config("whisper-tiny")
    assert (whisper.encdec.enc_layers, whisper.encdec.dec_layers) == (4, 4)


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


def test_serve_launcher_runs_the_new_families(capsys):
    for argv in (["--arch", "olmoe-1b-7b"], ["--arch", "pixtral-12b"],
                 ["--arch", "zamba2-1.2b"],
                 ["--arch", "zamba2-1.2b", "--long", "64", "--block", "16"]):
        assert launcher.main(argv + ["--batch", "2", "--prompt-len", "8",
                                     "--gen", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[prefill] 8 tokens x2") == 3
    assert "[long] ingested 64 tokens x2 in blocks of 16" in out
    with pytest.raises(SystemExit, match="whisper"):
        launcher.main(["--arch", "whisper-tiny", "--device", "cpu"])


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
