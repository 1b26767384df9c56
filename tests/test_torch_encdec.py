"""The port's encoder-decoder (whisper-tiny) and ``windowed_attention``
against the JAX package, at smoke scale.

Weights come from the JAX ``init_encdec``; its zero biases and unit norm
scales are overwritten with numpy draws before
``bridge.encdec_from_jax`` carries them across. The JAX side runs its
attention under the Pallas backend in interpret mode (S = 128). Each port
function is held against its own JAX function: ``encode``,
``decode_train`` (cross-attention without q/k/v biases) and
``init_encdec_cache`` + ``encdec_decode_step`` (with them). With random
biases the reference's prefill and decode disagree with each other, and so
do the port's; with zero biases they agree. 1e-4 in float32, 3e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import encdec as JE
from repro_torch import configs
from repro_torch.bridge import encdec_from_jax
from repro_torch.models import encdec as TE
from repro_torch.models.attention import windowed_attention
from repro_torch.serve.engine import make_decode_step, make_prefill_step

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
S_ENC, S_DEC = 128, 128


@pytest.fixture
def pallas_attention():
    JA.set_backend("pallas")
    yield
    JA.set_backend(None)


def _randomize(params, rng, biases=True):
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        name = path[-1]
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "bq", "bk", "bv") and biases:
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return a
    return walk(params)


def _system(dtype_name, biases=True, seed=0):
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = jax_smoke_config("whisper_tiny").with_(dtype=jdt)
    tcfg = configs.get_smoke_config("whisper_tiny").with_(dtype=tdt)
    params = _randomize(JE.init_encdec(jax.random.PRNGKey(seed), jcfg),
                        np.random.default_rng(seed + 1), biases)
    model = encdec_from_jax(params, tcfg, device="cpu")
    rng = np.random.default_rng(seed + 2)
    audio = rng.normal(size=(2, S_ENC, tcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab, (2, S_DEC))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, params),
                model=model, audio=audio, tokens=tokens, jdt=jdt, tdt=tdt,
                tol=tol)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_and_decode_train_match_jax(pallas_attention, dtype):
    s = _system(dtype)
    jenc = JE.encode(s["jp"], s["jcfg"], jnp.asarray(s["audio"]))
    enc = TE.encode(s["model"], torch.from_numpy(s["audio"]))
    assert enc.dtype == s["tdt"] and enc.shape == (2, S_ENC, 64)
    _close(enc, jenc, s["tol"])
    # the decoder from the same encoder output in both packages
    want = JE.decode_train(s["jp"], s["jcfg"], jnp.asarray(s["tokens"]),
                           jenc)
    got = TE.decode_train(s["model"], torch.from_numpy(s["tokens"]),
                          torch.from_numpy(np.array(
                              jenc.astype(jnp.float32))).to(s["tdt"]))
    assert got.shape == (2, S_DEC, s["tcfg"].vocab)
    _close(got, want, s["tol"])
    prefill = make_prefill_step(s["tcfg"])(
        s["model"], {"audio_embeds": torch.from_numpy(s["audio"]),
                     "tokens": torch.from_numpy(s["tokens"])})
    _close(prefill, want, s["tol"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_steps_match_jax(dtype):
    """The cross K/V with biases and four decode steps (logits, self-KV
    caches, position), from one encoder output in both packages."""
    s = _system(dtype, seed=3)
    jenc = JE.encode(s["jp"], s["jcfg"], jnp.asarray(s["audio"]))
    enc = torch.from_numpy(np.array(jenc.astype(jnp.float32))).to(s["tdt"])
    jc = JE.init_encdec_cache(s["jp"], s["jcfg"], jenc, max_len=8)
    tc = TE.init_encdec_cache(s["model"], enc, 8)
    for i in range(s["tcfg"].encdec.dec_layers):
        _close(tc.cross_k[i], jc.cross_k[i], s["tol"])
        _close(tc.cross_v[i], jc.cross_v[i], s["tol"])
    step = make_decode_step(s["tcfg"])
    for t in range(4):
        tok = s["tokens"][:, t]
        jl, jc = JE.encdec_decode_step(s["jp"], s["jcfg"], jc,
                                       jnp.asarray(tok, jnp.int32))
        tl, tc = step(s["model"], tc, torch.from_numpy(tok))
        _close(tl, jl, s["tol"])
    assert tc.pos == int(jc.pos) == 4
    for i, kv in enumerate(tc.self_kv):
        assert kv.length == 4
        _close(kv.k, jc.self_kv.k[i], s["tol"])
        _close(kv.v, jc.self_kv.v[i], s["tol"])


@pytest.mark.parametrize("biases", [False, True])
def test_cache_fill_against_teacher_forcing(biases):
    """Zero q/k/v biases: the cache fill's logits equal the teacher-forced
    pass's, position by position. Random biases: they differ, as the
    reference's do (its cross-attention adds the biases in decode only)."""
    s = _system("float32", biases=biases, seed=5)
    m = s["model"]
    toks = torch.from_numpy(s["tokens"][:, :8])
    enc = TE.encode(m, torch.from_numpy(s["audio"]))
    forced = TE.decode_train(m, toks, enc)
    cache = TE.init_encdec_cache(m, enc, 8)
    steps = []
    for t in range(8):
        lt, cache = TE.encdec_decode_step(m, cache, toks[:, t])
        steps.append(lt)
    gap = float((torch.stack(steps, 1) - forced).abs().max())
    jenc = JE.encode(s["jp"], s["jcfg"], jnp.asarray(s["audio"]))
    jforced = JE.decode_train(s["jp"], s["jcfg"], jnp.asarray(toks.numpy()),
                              jenc)
    jc = JE.init_encdec_cache(s["jp"], s["jcfg"], jenc, max_len=8)
    for t in range(8):
        jl, jc = JE.encdec_decode_step(s["jp"], s["jcfg"], jc,
                                       jnp.asarray(toks[:, t].numpy()))
    jgap = float(jnp.abs(jl - jforced[:, -1]).max())
    if biases:
        assert gap > 1e-3 and jgap > 1e-3
    else:
        assert gap < 1e-5 and jgap < 1e-5


def test_decoder_positions_wrap_past_8192():
    s = _system("float32", seed=7)
    m = s["model"]
    enc = TE.encode(m, torch.from_numpy(s["audio"]))
    cache = TE.init_encdec_cache(m, enc, 4)._replace(pos=8192 + 3)
    jenc = JE.encode(s["jp"], s["jcfg"], jnp.asarray(s["audio"]))
    jc = JE.init_encdec_cache(s["jp"], s["jcfg"], jenc, max_len=4)
    jc = jc._replace(pos=jnp.asarray(8192 + 3, jnp.int32))
    tok = s["tokens"][:, 0]
    tl, cache = TE.encdec_decode_step(m, cache, torch.from_numpy(tok))
    jl, _ = JE.encdec_decode_step(s["jp"], s["jcfg"], jc,
                                  jnp.asarray(tok, jnp.int32))
    _close(tl, jl, 1e-4)
    assert cache.pos == 8192 + 4


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kh,hd,w", [(2, 64, 4, 2, 16, 16),
                                          (1, 96, 6, 6, 8, 32),
                                          (1, 32, 2, 1, 16, 32)])
def test_windowed_attention_matches_jax(dtype, b, s, h, kh, hd, w):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(8)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    got = windowed_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)), w)
    want = JA.windowed_attention(*(jnp.asarray(a).astype(jdt)
                                   for a in (q, k, v)), w)
    assert got.dtype == tdt
    _close(got, want, tol)


def test_windowed_attention_equals_a_banded_mask():
    """The chunked form against full attention with the band mask (the
    flash kernel's plain version with ``window``)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, 64, 4, 16), generator=g) for _ in range(3))
    torch.testing.assert_close(windowed_attention(q, k, v, 16),
                               flash_attention_plain(q, k, v, causal=True,
                                                     window=16),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of window"):
        windowed_attention(q[:, :60], k[:, :60], v[:, :60], 16)
