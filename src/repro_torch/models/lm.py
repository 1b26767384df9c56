"""Unified LM: init, prefill forward and one-token decode for every
decoder-only family of the zoo.

Counterpart of ``repro/models/lm.py``:

  dense  -- pre-norm GQA attention + FFN blocks (qwen2-7b, qwen2-72b,
            starcoder2-15b, nemotron-4-15b)
  vlm    -- the dense backbone of pixtral-12b: prefill takes precomputed
            (vision + text) embeddings, decode embeds text tokens
  moe    -- GQA attention + MoE blocks (olmoe-1b-7b; arctic-480b with its
            dense residual FFN); prefill routes each batch row as a group,
            decode the B tokens of a step as one group
  ssm    -- RWKV-6 blocks, attention-free (rwkv6-3b)
  hybrid -- Mamba-2 layers with one SHARED attention block applied after
            every ``shared_attn_every`` layers (zamba2); windowed when the
            prompt is longer than 65536 tokens

The JAX package stacks the layers on a leading axis and scans them; here
the LM holds one module per layer and loops. The forwards are
grad-transparent (serving callers run them under ``torch.no_grad()``).
When gradients flow, each block, and the hybrid's shared block, runs under
``torch.utils.checkpoint`` with the reference's remat policies (``full``
saves nothing, ``dots`` the matmul outputs, ``dots_no_batch`` those
without a batch dim); ``xent_loss`` and ``lm_loss`` are the training loss.
The audio family is the encoder-decoder of ``models/encdec.py``. Weights
are drawn from a seeded ``torch.Generator`` on the target device with the JAX
initialisers' distributions; they cannot reproduce ``jax.random``, so
parity checks carry JAX weights across with ``bridge.lm_from_jax``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.api import (lookup, products_summed,
                                         shard_hidden, weight,
                                         with_summed_products)
from repro_torch.nn import LayerNorm, RMSNorm, frozen, normal, seeded
from repro_torch.models.attention import (Attention, KVCache,
                                          attention_apply, attention_decode,
                                          init_kv_cache)
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.mamba2 import (Mamba2Block, init_mamba2_state,
                                       mamba2_block, mamba2_block_step)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rwkv6 import (RWKV6Block, init_rwkv6_state,
                                      rwkv6_block, rwkv6_block_step)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
# the hybrid's shared block attends to the whole prompt up to this length,
# and over ``attn_window_long`` beyond it
LONG_PROMPT = 65536


def check_family(cfg: ArchConfig) -> None:
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name} is an encoder-decoder: build it with "
                         f"models.encdec.init_encdec")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} of {cfg.name}")


def _norm(cfg: ArchConfig, device) -> nn.Module:
    """RMSNorm (with the low-memory backward when ``cfg.norm_grad`` is
    ``"bf16"``, as the reference's ``_norm`` dispatches) or LayerNorm."""
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, dtype=cfg.param_dtype, device=device,
                       lowmem=cfg.norm_grad == "bf16")
    return LayerNorm(cfg.d_model, dtype=cfg.param_dtype, device=device)


class AttnBlock(nn.Module):
    """ln1 -> attention -> residual, ln2 -> FFN (or MoE) -> residual."""

    def __init__(self, cfg: ArchConfig, *, gen=None, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, gen=gen, device=device)
        self.ln1 = _norm(cfg, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = _norm(cfg, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.moe, cfg.act, **kw)
        else:
            self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.act, **kw)


def _layer(cfg: ArchConfig, gen, device) -> nn.Module:
    if cfg.family == "ssm":
        return RWKV6Block(cfg.d_model, cfg.ssm.head_dim,
                          lora_rank=cfg.ssm.decay_lora, d_ff=cfg.d_ff,
                          dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                          gen=gen, device=device)
    if cfg.family == "hybrid":
        return Mamba2Block(cfg.d_model, state_dim=cfg.ssm.state_dim,
                           head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand,
                           conv_width=cfg.ssm.conv_width, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, gen=gen,
                           device=device)
    return AttnBlock(cfg, gen=gen, device=device)


def segment_bounds(cfg: ArchConfig) -> list[tuple[int, int]]:
    """The hybrid schedule: [lo, hi) runs of Mamba-2 layers, the shared
    block after each; one run of every layer for the other families."""
    if cfg.family != "hybrid":
        return [(0, cfg.n_layers)]
    step = cfg.hybrid.shared_attn_every
    return [(i, min(i + step, cfg.n_layers))
            for i in range(0, cfg.n_layers, step)]


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and LM head. ``device=None``
    means the card; the weights are drawn there from ``seed``. On the
    ``meta`` device the weights have shapes and no values: a skeleton for
    ``torch.func.functional_call``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        gen = seeded(dev, seed)
        self.cfg = cfg
        self.layers = nn.ModuleList([_layer(cfg, gen, dev)
                                     for _ in range(cfg.n_layers)])
        self.final_norm = _norm(cfg, dev)
        kw = dict(gen=gen, dtype=cfg.dtype, device=dev)
        # vlm: prefill takes embeddings, but decode embeds text tokens
        self.embed = frozen(normal((cfg.vocab, cfg.d_model), **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        frozen(normal((cfg.d_model, cfg.vocab), **kw)))
        self.shared = (AttnBlock(cfg.with_(moe=None), gen=gen, device=dev)
                       if cfg.family == "hybrid" else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _attn_ffn_block(lp: AttnBlock, x, cfg: ArchConfig, *, window=None,
                    dtype=None, attention: str = "flash", routes=None):
    """-> (y, aux): aux is the MoE balance loss (0 for an FFN block)."""
    h = attention_apply(lp.attn, lp.ln1(x), n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                        rope_theta=cfg.rope_theta, causal=True, window=window,
                        dtype=dtype, impl=attention)
    x = x + h
    xn = lp.ln2(x)
    if cfg.moe is not None:
        y, aux = moe_apply(lp.moe, xn, cfg.moe, dtype=dtype, routes=routes)
    else:
        y, aux = ffn_apply(lp.ffn, xn, dtype=dtype), 0.0
    return shard_hidden(x + y, "batch", None, "act_hidden"), aux


REMAT_POLICIES = ("full", "dots", "dots_no_batch")
# the ops whose outputs a policy keeps (``jax.checkpoint_policies``
# ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``): ``x @ w``
# with a 2-D weight dispatches to mm/addmm, an einsum with a batch dim to
# bmm/baddbmm
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm),
    "dots_no_batch": (torch.ops.aten.mm, torch.ops.aten.addmm),
}


def _saved_by(ops, ctx, op, *args, **kwargs):
    if getattr(op, "overloadpacket", None) in ops:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, policy: str = "full"):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): ``full``
    keeps only its inputs and recomputes the rest in the backward; ``dots``
    and ``dots_no_batch`` also keep the outputs of their matmuls."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    kw = {}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_saved_by, _SAVED_OPS[policy]))
    if products_summed():
        # in a cell: the recompute sums its products as the forward did
        kw["context_fn"] = functools.partial(
            with_summed_products, kw.get("context_fn", noop_context_fn))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _layer_block(lp, x, cfg: ArchConfig, *, window, dtype, attention,
                 routes):
    """One layer of the stack -> (y, aux)."""
    if cfg.family == "ssm":
        y = rwkv6_block(lp, x, head_dim=cfg.ssm.head_dim,
                        chunk=cfg.ssm.chunk, dtype=dtype)
        return shard_hidden(y, "batch", None, "act_hidden"), 0.0
    if cfg.family == "hybrid":
        y = mamba2_block(lp, x, state_dim=cfg.ssm.state_dim,
                         head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand,
                         chunk=cfg.ssm.chunk, dtype=dtype)
        return shard_hidden(y, "batch", None, "act_hidden"), 0.0
    return _attn_ffn_block(lp, x, cfg, window=window, dtype=dtype,
                           attention=attention, routes=routes)


def lm_hidden(model: LM, *, tokens=None, embeds=None, window=None,
              attention: str = "flash", routes: list | None = None,
              remat: bool = True, remat_policy: str = "full"):
    """Run the stack -> (hidden (B, S, D), aux): aux is the MoE balance loss
    summed over the layers (0 for the other families). ``attention`` picks
    the prefill attention of the attention blocks (``"flash"``: the kernel
    wrapper; ``"blocked"``: the plain jnp-path counterpart). ``routes``,
    when given, gets each MoE layer's ``moe.Routing`` in order; such a
    forward runs without remat, whose recompute would route again. With
    grad mode on and ``remat``, each block runs under :func:`checkpointed`
    with ``remat_policy``."""
    cfg = model.cfg
    dtype = cfg.dtype
    x = lookup(model.embed, tokens).to(dtype) if embeds is None \
        else embeds.to(dtype)
    x = shard_hidden(x, "batch", None, "act_hidden")
    remat = remat and torch.is_grad_enabled() and routes is None
    wrap = functools.partial(checkpointed, policy=remat_policy) if remat \
        else (lambda fn: fn)
    aux_total = 0.0
    for lo, hi in segment_bounds(cfg):
        for lp in model.layers[lo:hi]:
            x, aux = wrap(functools.partial(
                _layer_block, lp, cfg=cfg, window=window, dtype=dtype,
                attention=attention, routes=routes))(x)
            aux_total = aux_total + aux
        if cfg.family == "hybrid":
            shared_window = window or (cfg.hybrid.attn_window_long
                                       if x.shape[1] > LONG_PROMPT else None)
            x, _ = wrap(functools.partial(
                _attn_ffn_block, model.shared, cfg=cfg.with_(moe=None),
                window=shared_window, dtype=dtype, attention=attention))(x)
    return model.final_norm(x), aux_total



def lm_logits(model: LM, hidden: torch.Tensor) -> torch.Tensor:
    w = model.embed.t() if model.lm_head is None else model.lm_head
    logits = hidden @ weight(w, model.cfg.dtype)
    return shard_hidden(logits, "batch", None, "vocab")


def lm_forward(model: LM, *, tokens=None, embeds=None, window=None,
               attention: str = "flash", routes: list | None = None,
               remat: bool = True, remat_policy: str = "full"):
    """-> (logits (B, S, V) in the compute dtype, aux)."""
    hidden, aux = lm_hidden(model, tokens=tokens, embeds=embeds,
                            window=window, attention=attention,
                            routes=routes, remat=remat,
                            remat_policy=remat_policy)
    return lm_logits(model, hidden), aux


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in float32: logsumexp minus the gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # DTensor's gather on a vocab-sharded dim fails in its mask
        # buffer: the gold logit is read from logits whole over the vocab
        logits = logits.redistribute(logits.device_mesh, tuple(
            Replicate() if p == Shard(2) else p for p in logits.placements))
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def lm_loss(model: LM, batch: dict, *, window=None, remat: bool = True,
            remat_policy: str = "full", attention: str = "flash"):
    """``xent_loss`` of the logits of ``batch["tokens"]`` (or ``embeds``)
    against ``batch["labels"]``, plus ``aux_loss_weight * aux / n_layers``
    for an MoE config."""
    cfg = model.cfg
    logits, aux = lm_forward(model, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), window=window,
                             attention=attention, remat=remat,
                             remat_policy=remat_policy)
    loss = xent_loss(logits, batch["labels"])
    if cfg.moe is not None:
        # a 0-dim divisor on aux's device: an IEEE divide on the card
        loss = loss + cfg.moe.aux_loss_weight * aux / torch.tensor(
            float(cfg.n_layers), device=aux.device)
    return loss


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer decode state: KV caches (dense, vlm, moe), RWKV states
    (ssm), or Mamba-2 states and one KV cache per shared-block call
    (hybrid)."""
    kv: Optional[list] = None         # [KVCache] per layer
    rwkv: Optional[list] = None       # [RWKV6State] per layer
    ssm: Optional[list] = None        # [Mamba2State] per layer
    shared_kv: Optional[list] = None  # [KVCache] per segment


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeCache:
    check_family(cfg)
    dev = resolve_device(device)

    def kv_caches(n):
        return [init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd,
                              cfg.dtype, device=dev) for _ in range(n)]
    if cfg.family == "ssm":
        return DecodeCache(rwkv=[
            init_rwkv6_state(batch, cfg.d_model, cfg.ssm.head_dim, cfg.dtype,
                             device=dev) for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        return DecodeCache(ssm=[
            init_mamba2_state(batch, cfg.d_model,
                              state_dim=cfg.ssm.state_dim,
                              head_dim=cfg.ssm.head_dim,
                              expand=cfg.ssm.expand,
                              conv_width=cfg.ssm.conv_width, dtype=cfg.dtype,
                              device=dev) for _ in range(cfg.n_layers)],
            shared_kv=kv_caches(len(segment_bounds(cfg))))
    return DecodeCache(kv=kv_caches(cfg.n_layers))


def _attn_block_decode(lp: AttnBlock, x, kv: KVCache, cfg: ArchConfig, dtype,
                       routes=None):
    """x (B, D), one token through one attention block. An MoE block routes
    the B tokens as one group."""
    h, new_kv = attention_decode(lp.attn, lp.ln1(x[:, None, :]), kv,
                                 n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                                 rope_theta=cfg.rope_theta, dtype=dtype)
    x = x + h[:, 0]
    xn = lp.ln2(x[:, None, :])
    if cfg.moe is not None:
        y, _ = moe_apply(lp.moe, xn.reshape(1, x.shape[0], -1), cfg.moe,
                         dtype=dtype, routes=routes)
        y = y.reshape(x.shape)
    else:
        y = ffn_apply(lp.ffn, xn, dtype=dtype)[:, 0]
    return x + y, new_kv


@torch.no_grad()
def lm_decode_step(model: LM, cache: DecodeCache, token, embeds=None,
                   routes: list | None = None):
    """One decode step. token (B,) int (or embeds (B, D)) -> (logits (B, V),
    new cache). KV caches are written in place. ``routes``, when given,
    gets each MoE layer's ``moe.Routing`` (one group of B tokens)."""
    cfg = model.cfg
    dtype = cfg.dtype
    x = lookup(model.embed, token).to(dtype) if embeds is None \
        else embeds.to(dtype)
    if cfg.family == "ssm":
        states = []
        for lp, st in zip(model.layers, cache.rwkv):
            x, st = rwkv6_block_step(lp, x, st, head_dim=cfg.ssm.head_dim,
                                     dtype=dtype)
            states.append(st)
        new_cache = DecodeCache(rwkv=states)
    elif cfg.family == "hybrid":
        states, kvs = [], []
        shared_cfg = cfg.with_(moe=None)
        for (lo, hi), kv in zip(segment_bounds(cfg), cache.shared_kv):
            for lp, st in zip(model.layers[lo:hi], cache.ssm[lo:hi]):
                x, st = mamba2_block_step(
                    lp, x, st, state_dim=cfg.ssm.state_dim,
                    head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand,
                    dtype=dtype)
                states.append(st)
            x, kv = _attn_block_decode(model.shared, x, kv, shared_cfg,
                                       dtype)
            kvs.append(kv)
        new_cache = DecodeCache(ssm=states, shared_kv=kvs)
    else:
        kvs = []
        for lp, kv in zip(model.layers, cache.kv):
            x, kv = _attn_block_decode(lp, x, kv, cfg, dtype, routes)
            kvs.append(kv)
        new_cache = DecodeCache(kv=kvs)
    x = model.final_norm(x[:, None, :])
    return lm_logits(model, x)[:, 0], new_cache
