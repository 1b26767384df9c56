"""Unified LM for the dense and ssm families: init, prefill forward and
one-token decode.

Counterpart of ``repro/models/lm.py``:

  dense -- pre-norm GQA attention + FFN blocks (qwen2-7b, qwen2-72b,
           starcoder2-15b, nemotron-4-15b)
  ssm   -- RWKV-6 blocks, attention-free (rwkv6-3b)

The JAX package stacks the layers on a leading axis and scans them; here
the LM holds one module per layer and loops. Remat is a training concern
and is not ported. moe, hybrid, vlm and audio raise NotImplementedError:
they come with the rest of the zoo (ROADMAP Queue 1 step 9). Weights are
drawn from a seeded ``torch.Generator`` on the target device with the JAX
initialisers' distributions; they cannot reproduce ``jax.random``, so
parity checks carry JAX weights across with ``bridge.lm_from_jax``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn import LayerNorm, RMSNorm, frozen, normal
from repro_torch.models.attention import (Attention, KVCache,
                                          attention_apply, attention_decode,
                                          init_kv_cache)
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.rwkv6 import (RWKV6Block, init_rwkv6_state,
                                      rwkv6_block, rwkv6_block_step)

FAMILIES = ("dense", "ssm")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the {', '.join(FAMILIES)} families so far; "
            f"{cfg.name} is {cfg.family!r}, which comes with the rest of the "
            f"LM zoo (ROADMAP Queue 1 step 9)")


def _norm(cfg: ArchConfig, device) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, dtype=cfg.param_dtype, device=device)


class AttnBlock(nn.Module):
    """ln1 -> attention -> residual, ln2 -> FFN -> residual."""

    def __init__(self, cfg: ArchConfig, *, gen=None, device=None):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, qkv_bias=cfg.qkv_bias, dtype=cfg.dtype,
                              gen=gen, device=device)
        self.ln2 = _norm(cfg, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.act, dtype=cfg.dtype,
                       gen=gen, device=device)


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and LM head. ``device=None``
    means the card; the weights are drawn there from ``seed``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        if cfg.family == "ssm":
            layers = [RWKV6Block(cfg.d_model, cfg.ssm.head_dim,
                                 lora_rank=cfg.ssm.decay_lora, d_ff=cfg.d_ff,
                                 dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                 gen=gen, device=dev)
                      for _ in range(cfg.n_layers)]
        else:
            layers = [AttnBlock(cfg, gen=gen, device=dev)
                      for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(layers)
        self.final_norm = _norm(cfg, dev)
        kw = dict(gen=gen, dtype=cfg.dtype, device=dev)
        self.embed = frozen(normal((cfg.vocab, cfg.d_model), **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        frozen(normal((cfg.d_model, cfg.vocab), **kw)))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _attn_ffn_block(lp: AttnBlock, x, cfg: ArchConfig, *, window=None,
                    dtype=None, attention: str = "flash"):
    h = attention_apply(lp.attn, lp.ln1(x), n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                        rope_theta=cfg.rope_theta, causal=True, window=window,
                        dtype=dtype, impl=attention)
    x = x + h
    return x + ffn_apply(lp.ffn, lp.ln2(x), dtype=dtype)


@torch.no_grad()
def lm_hidden(model: LM, *, tokens=None, embeds=None, window=None,
              attention: str = "flash"):
    """Run the stack -> (hidden (B, S, D), aux). aux is the MoE balance loss
    of the JAX package, 0 for these families. ``attention`` picks the
    prefill attention of dense layers (``"flash"``: the kernel wrapper;
    ``"blocked"``: the plain jnp-path counterpart)."""
    cfg = model.cfg
    dtype = cfg.dtype
    x = model.embed[tokens].to(dtype) if embeds is None else embeds.to(dtype)
    for lp in model.layers:
        if cfg.family == "ssm":
            x = rwkv6_block(lp, x, head_dim=cfg.ssm.head_dim,
                            chunk=cfg.ssm.chunk, dtype=dtype)
        else:
            x = _attn_ffn_block(lp, x, cfg, window=window, dtype=dtype,
                                attention=attention)
    return model.final_norm(x), 0.0


def lm_logits(model: LM, hidden: torch.Tensor) -> torch.Tensor:
    w = model.embed.t() if model.lm_head is None else model.lm_head
    return hidden @ w.to(model.cfg.dtype)


@torch.no_grad()
def lm_forward(model: LM, *, tokens=None, embeds=None, window=None,
               attention: str = "flash"):
    """-> (logits (B, S, V) in the compute dtype, aux)."""
    hidden, aux = lm_hidden(model, tokens=tokens, embeds=embeds,
                            window=window, attention=attention)
    return lm_logits(model, hidden), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer decode state: KV caches (dense) or RWKV states (ssm)."""
    kv: Optional[list] = None         # [KVCache] per layer
    rwkv: Optional[list] = None       # [RWKV6State] per layer


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeCache:
    check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return DecodeCache(rwkv=[
            init_rwkv6_state(batch, cfg.d_model, cfg.ssm.head_dim, cfg.dtype,
                             device=dev) for _ in range(cfg.n_layers)])
    return DecodeCache(kv=[
        init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, cfg.dtype,
                      device=dev) for _ in range(cfg.n_layers)])


def _attn_block_decode(lp: AttnBlock, x, kv: KVCache, cfg: ArchConfig, dtype):
    """x (B, D), one token through one attention block."""
    h, new_kv = attention_decode(lp.attn, lp.ln1(x[:, None, :]), kv,
                                 n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                                 rope_theta=cfg.rope_theta, dtype=dtype)
    x = x + h[:, 0]
    return x + ffn_apply(lp.ffn, lp.ln2(x[:, None, :]), dtype=dtype)[:, 0], \
        new_kv


@torch.no_grad()
def lm_decode_step(model: LM, cache: DecodeCache, token, embeds=None):
    """One decode step. token (B,) int (or embeds (B, D)) -> (logits (B, V),
    new cache). KV caches are written in place."""
    cfg = model.cfg
    dtype = cfg.dtype
    x = model.embed[token].to(dtype) if embeds is None else embeds.to(dtype)
    if cfg.family == "ssm":
        states = []
        for lp, st in zip(model.layers, cache.rwkv):
            x, st = rwkv6_block_step(lp, x, st, head_dim=cfg.ssm.head_dim,
                                     dtype=dtype)
            states.append(st)
        new_cache = DecodeCache(rwkv=states)
    else:
        kvs = []
        for lp, kv in zip(model.layers, cache.kv):
            x, kv = _attn_block_decode(lp, x, kv, cfg, dtype)
            kvs.append(kv)
        new_cache = DecodeCache(kv=kvs)
    x = model.final_norm(x[:, None, :])
    return lm_logits(model, x)[:, 0], new_cache

