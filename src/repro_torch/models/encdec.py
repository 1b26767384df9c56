"""Whisper-style encoder-decoder backbone (whisper-tiny).

Counterpart of ``repro/models/encdec.py``. The conv audio frontend is a
stub, as in the reference: the encoder takes precomputed frame embeddings
(B, S_enc, D). Encoder blocks are bidirectional LayerNorm attention + GELU
FFN; decoder blocks causal self-attention, cross-attention and FFN, with
learned positions (8192 of them) and the output head tied to
``dec_embed``. Attention over a sequence goes through the flash wrapper
(the encoder's self-attention, the decoder's self- and cross-attention);
decode attends the self-attention KV caches and the cross K/V computed once
from the encoder's output.

``encode`` and ``decode_train`` are grad-transparent (serving callers run
them under ``torch.no_grad()``); when gradients flow, every encoder and
decoder block runs under the reference's fixed ``full`` remat, and
``encdec_loss`` is the training loss.

The reference is inconsistent with itself, and the port copies it:
``attention_apply``'s cross-attention (``encode``/``decode_train``) adds
no q/k/v biases, while ``init_encdec_cache`` and ``encdec_decode_step``
add them. With ``init_encdec``'s zero biases the two agree.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.api import (heads_on_shards, heads_view,
                                         lookup, shard_hidden, weight)
from repro_torch.models.attention import (Attention, KVCache,
                                          attention_apply, attention_decode,
                                          decode_softmax, init_kv_cache)
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.lm import checkpointed, xent_loss
from repro_torch.nn import LayerNorm, frozen, normal, seeded

N_POS = 8192            # learned decoder positions


class EncBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, gen=None, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, gen=gen, device=device)
        self.ln1 = LayerNorm(cfg.d_model, dtype=cfg.param_dtype,
                             device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, qkv_bias=True, **kw)
        self.ln2 = LayerNorm(cfg.d_model, dtype=cfg.param_dtype,
                             device=device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, "gelu", **kw)


class DecBlock(EncBlock):
    def __init__(self, cfg: ArchConfig, *, gen=None, device=None):
        super().__init__(cfg, gen=gen, device=device)
        self.ln_x = LayerNorm(cfg.d_model, dtype=cfg.param_dtype,
                              device=device)
        self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, qkv_bias=True, dtype=cfg.dtype,
                               gen=gen, device=device)


class EncDec(nn.Module):
    """``device=None`` means the card; weights drawn there from ``seed``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name} has no encoder-decoder config")
        dev = resolve_device(device)
        gen = seeded(dev, seed)
        ed = cfg.encdec
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(
            [EncBlock(cfg, gen=gen, device=dev) for _ in range(ed.enc_layers)])
        self.enc_norm = LayerNorm(cfg.d_model, dtype=cfg.param_dtype,
                                  device=dev)
        kw = dict(gen=gen, dtype=cfg.dtype, device=dev)
        self.dec_embed = frozen(normal((cfg.vocab, cfg.d_model), **kw))
        self.dec_pos = frozen(normal((N_POS, cfg.d_model), **kw))
        self.dec_layers = nn.ModuleList(
            [DecBlock(cfg, gen=gen, device=dev) for _ in range(ed.dec_layers)])
        self.dec_norm = LayerNorm(cfg.d_model, dtype=cfg.param_dtype,
                                  device=dev)

    @property
    def device(self) -> torch.device:
        return self.dec_embed.device


def init_encdec(cfg: ArchConfig, *, seed: int = 0, device=None) -> EncDec:
    return EncDec(cfg, seed=seed, device=device)


def _attn(cfg: ArchConfig, p: Attention, x, **kw):
    return attention_apply(p, x, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           rope_theta=cfg.rope_theta, dtype=cfg.dtype, **kw)


def _blocks(fn, layers, x):
    """x through ``fn(layer, x)`` for each layer, each block under the
    reference's ``full`` remat when gradients flow."""
    remat = torch.is_grad_enabled()
    for lp in layers:
        step = functools.partial(fn, lp)
        x = checkpointed(step)(x) if remat else step(x)
    return x


def encode(model: EncDec, audio_embeds, *, attention: str = "flash"):
    """audio_embeds (B, S_enc, D) -> the encoder's output (B, S_enc, D)."""
    cfg = model.cfg

    def block(lp, x):
        x = x + _attn(cfg, lp.attn, lp.ln1(x), causal=False, impl=attention)
        x = x + ffn_apply(lp.ffn, lp.ln2(x), dtype=cfg.dtype)
        return shard_hidden(x, "batch", None, "act_hidden")
    x = shard_hidden(audio_embeds.to(cfg.dtype), "batch", None, "act_hidden")
    x = _blocks(block, model.enc_layers, x)
    return model.enc_norm(x)


def decode_train(model: EncDec, tokens, enc_out, *, attention: str = "flash"):
    """Teacher-forced decoder pass: tokens (B, S_dec) -> logits (B, S_dec,
    V). Beyond 8192 tokens the position table repeats."""
    cfg = model.cfg
    dtype = cfg.dtype
    s = tokens.shape[1]
    pos = model.dec_pos
    if s > pos.shape[0]:
        pos = pos.repeat(-(-s // pos.shape[0]), 1)

    def block(lp, x):
        x = x + _attn(cfg, lp.attn, lp.ln1(x), causal=True, impl=attention)
        x = x + _attn(cfg, lp.xattn, lp.ln_x(x), kv_override=enc_out,
                      impl=attention)
        x = x + ffn_apply(lp.ffn, lp.ln2(x), dtype=dtype)
        return shard_hidden(x, "batch", None, "act_hidden")
    x = lookup(model.dec_embed, tokens).to(dtype) + pos[:s][None].to(dtype)
    x = shard_hidden(x, "batch", None, "act_hidden")
    x = model.dec_norm(_blocks(block, model.dec_layers, x))
    logits = x @ model.dec_embed.t().to(dtype)
    return shard_hidden(logits, "batch", None, "vocab")


def encdec_loss(model: EncDec, batch: dict, *, attention: str = "flash"):
    """``xent_loss`` of the teacher-forced logits of ``batch["tokens"]``
    over the encoding of ``batch["audio_embeds"]`` against
    ``batch["labels"]``."""
    enc_out = encode(model, batch["audio_embeds"], attention=attention)
    logits = decode_train(model, batch["tokens"], enc_out,
                          attention=attention)
    return xent_loss(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: list          # [KVCache] per decoder layer
    cross_k: list          # [(B, S_enc, KH, hd)] per decoder layer
    cross_v: list
    pos: int               # tokens decoded so far


def init_encdec_cache(model: EncDec, enc_out, max_len: int) -> EncDecCache:
    """The cross K/V of every decoder layer from the encoder's output (with
    the k/v biases) and empty self-attention KV caches."""
    cfg = model.cfg
    dtype = cfg.dtype
    b, s, _ = enc_out.shape
    src = enc_out.to(dtype)
    cross_k, cross_v = [], []
    for lp in model.dec_layers:
        k = src @ weight(lp.xattn.wk, dtype)
        v = src @ weight(lp.xattn.wv, dtype)
        if lp.xattn.qkv_bias:
            k = k + weight(lp.xattn.bk, dtype)
            v = v + weight(lp.xattn.bv, dtype)
        shape = (b, s, cfg.n_kv_heads, cfg.hd)
        cross_k.append(heads_view(k, shape, cfg.n_kv_heads))
        cross_v.append(heads_view(v, shape, cfg.n_kv_heads))
    self_kv = [init_kv_cache(b, max_len, cfg.n_kv_heads, cfg.hd, dtype,
                             device=enc_out.device)
               for _ in model.dec_layers]
    return EncDecCache(self_kv=self_kv, cross_k=cross_k, cross_v=cross_v,
                       pos=0)


@torch.no_grad()
def encdec_decode_step(model: EncDec, cache: EncDecCache, token):
    """One decoder token (B,) against the self-attention caches (written in
    place) and the fixed cross K/V -> (logits (B, V), new cache)."""
    cfg = model.cfg
    dtype = cfg.dtype
    b = token.shape[0]
    hd, kh = cfg.hd, cfg.n_kv_heads

    def cross(q, ck, cv):
        return decode_softmax(q, ck, cv, 0, ck.shape[1])
    x = lookup(model.dec_embed, token).to(dtype) \
        + model.dec_pos[cache.pos % model.dec_pos.shape[0]].to(dtype)
    new_kv = []
    for lp, kv, ck, cv in zip(model.dec_layers, cache.self_kv, cache.cross_k,
                              cache.cross_v):
        h, kv = attention_decode(lp.attn, lp.ln1(x[:, None, :]), kv,
                                 n_heads=cfg.n_heads, n_kv_heads=kh,
                                 head_dim=hd, rope_theta=cfg.rope_theta,
                                 dtype=dtype)
        new_kv.append(kv)
        x = x + h[:, 0]
        # cross-attention against the precomputed K/V (no cache update)
        q = lp.ln_x(x[:, None, :]) @ weight(lp.xattn.wq, dtype)
        if lp.xattn.qkv_bias:
            q = q + weight(lp.xattn.bq, dtype)
        q = heads_view(q, (b, 1, cfg.n_heads, hd), cfg.n_heads)
        if isinstance(q, DTensor):
            hx = heads_on_shards(cross, q, ck, cv)
        else:
            hx = cross(q, ck, cv)
        hx = heads_view(hx, (b, 1, cfg.n_heads * hd), cfg.n_heads) \
            .to(dtype) @ weight(lp.xattn.wo, dtype)
        x = x + hx[:, 0]
        x = x + ffn_apply(lp.ffn, lp.ln2(x[:, None, :]), dtype=dtype)[:, 0]
    x = model.dec_norm(x[:, None, :])
    logits = (x @ model.dec_embed.t().to(dtype))[:, 0]
    return logits, cache._replace(self_kv=new_kv, pos=cache.pos + 1)
