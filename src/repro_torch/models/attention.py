"""GQA attention with RoPE: prefill (full or windowed causal),
cross-attention (queries from x, keys and values from an encoder's
output), banded ``windowed_attention``, and one-token decode against a KV
cache.

Counterpart of ``repro/models/attention.py``. Public tensors keep the JAX
layout (B, S, H, hd). Prefill attention goes through the flash wrapper
(``impl="flash"``): on the card every prefill launches the kernel, whatever
its length, and on the CPU the wrapper runs its plain version.
``impl="blocked"`` runs ``blocked_attention`` (the JAX package's jnp path:
the kernel's plain version q block by q block) on any device; the smoke
check holds the kernel against it. Decode attention is plain torch, as it
is jnp einsum in the JAX package. Under ``distributed.flash_decode_ctx``
each KV cache holds its rank's S_max / W slots of a sequence-sharded cache
(``init_kv_cache`` allocates that shard) and decode goes through
``distributed.collectives.seq_sharded_decode_attention``: the token is
written by the rank that holds its slot and the shards' partial softmaxes
merge with two all-reduces.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.api import (current_flash_decode,
                                         heads_on_shards, heads_view,
                                         shard_hidden, weight, write_slot)
from repro_torch.distributed.collectives import (axis_group,
                                                 seq_sharded_decode_attention)
from repro_torch.nn import frozen, normal
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 softmax_scale)

IMPLS = ("flash", "blocked")


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (..., S) int -> cos/sin of shape (..., S, head_dim // 2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd/2) or (S, hd/2)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq/wk/wv/wo in the JAX (in, out) layout, stored in ``dtype`` (every
    use casts them to the compute dtype); optional QKV bias."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False,
                 dtype=torch.float32, gen=None, device=None):
        super().__init__()
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.wq = frozen(normal((d_model, n_heads * head_dim), **kw))
        self.wk = frozen(normal((d_model, n_kv_heads * head_dim), **kw))
        self.wv = frozen(normal((d_model, n_kv_heads * head_dim), **kw))
        self.wo = frozen(normal((n_heads * head_dim, d_model), **kw))
        self.qkv_bias = qkv_bias
        if qkv_bias:
            for name, n in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
                setattr(self, name, frozen(torch.zeros(
                    n * head_dim, dtype=dtype, device=device)))


def _project_qkv(p: Attention, x, n_heads, n_kv_heads, head_dim, dtype):
    b, s, _ = x.shape
    q = x @ weight(p.wq, dtype)
    k = x @ weight(p.wk, dtype)
    v = x @ weight(p.wv, dtype)
    if p.qkv_bias:
        q = q + weight(p.bq, dtype)
        k = k + weight(p.bk, dtype)
        v = v + weight(p.bv, dtype)
    return (heads_view(q, (b, s, n_heads, head_dim), n_heads),
            heads_view(k, (b, s, n_kv_heads, head_dim), n_kv_heads),
            heads_view(v, (b, s, n_kv_heads, head_dim), n_kv_heads))


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd): kv head j serves q heads j*g..j*g+g-1."""
    kh = k.shape[2]
    return k if kh == h else k.repeat_interleave(h // kh, dim=2)


def blocked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      window: Optional[int] = None, q_block: int = 1024):
    """q (B, Sq, H, hd), k/v (B, Sk, KH, hd). The flash kernel's plain
    version, q block by q block, so the score buffer is (q_block, Sk) per
    head. Query i sits at position i + ``q_offset``."""
    return torch.cat([
        flash_attention_plain(q[:, start:start + q_block], k, v,
                              causal=causal, window=window,
                              q_offset=start + q_offset)
        for start in range(0, q.shape[1], q_block)], dim=1)


def windowed_attention(q, k, v, window: int):
    """Banded causal attention: each position sees the previous ``window``
    positions, itself included. q (B, S, H, hd), k/v (B, S, KH, hd); S must
    be a multiple of ``window``. Chunked as the reference does: the queries
    of chunk i score against chunks i-1 and i (a zero chunk before the
    first, masked), so the scores are O(S * 2W), float32 softmax. Plain
    torch, as the reference is jnp; no model calls it."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g, w = h // kh, window
    if s % w:
        raise ValueError(f"seq {s} is not a multiple of window {w}")
    nc = s // w
    kc = k.reshape(b, nc, w, kh, hd)
    vc = v.reshape(b, nc, w, kh, hd)
    k2 = torch.cat([F.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), kc], dim=2)
    v2 = torch.cat([F.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), vc], dim=2)
    qg = q.reshape(b, nc, w, kh, g, hd)
    scores = torch.einsum("bnqkgh,bnskh->bnkgqs", qg.float(), k2.float()) \
        * softmax_scale(hd)
    qpos = torch.arange(w, device=q.device)[:, None] + w
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)          # (W, 2W)
    first = torch.arange(nc, device=q.device) == 0
    valid = mask[None] & ~(first[:, None, None] & (kpos < w)[None])
    scores = scores.masked_fill(~valid[None, :, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", probs, v2.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def attention_apply(p: Attention, x, *, n_heads, n_kv_heads, head_dim,
                    rope_theta, positions=None, causal=True,
                    window: Optional[int] = None, kv_override=None,
                    dtype=None, impl: str = "flash"):
    """Attention over a prompt, x (B, S, D) -> (B, S, D). With
    ``kv_override`` (B, Sk, D), cross-attention: queries from x, keys and
    values from ``kv_override``, no RoPE, never causal, and (as in the
    reference) no q/k/v biases."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dtype = dtype or x.dtype
    b, s, _ = x.shape
    if kv_override is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, dtype)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        cos, sin = rope_freqs(head_dim, rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        src = kv_override
        sk = src.shape[1]
        q = heads_view(x @ weight(p.wq, dtype), (b, s, n_heads, head_dim),
                       n_heads)
        k = heads_view(src @ weight(p.wk, dtype),
                       (b, sk, n_kv_heads, head_dim), n_kv_heads)
        v = heads_view(src @ weight(p.wv, dtype),
                       (b, sk, n_kv_heads, head_dim), n_kv_heads)
        causal = False
    q = shard_hidden(q, "batch", None, "heads", None)
    k = shard_hidden(k, "batch", None, "heads", None)
    v = shard_hidden(v, "batch", None, "heads", None)
    if impl == "flash":
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = blocked_attention(q, k, v, causal=causal, window=window)
    return heads_view(out, (b, s, n_heads * head_dim), n_heads) \
        @ weight(p.wo, dtype)


class KVCache(NamedTuple):
    """``start``: the position of slot 0 (0 but for a cache seeded from a
    long ingest's window); ``window``: decode attends the last ``window``
    positions only (None: every filled slot)."""
    k: torch.Tensor        # (B, S_max, K, hd)
    v: torch.Tensor
    length: int            # tokens currently in the cache
    start: int = 0
    window: Optional[int] = None


def init_kv_cache(batch, max_len, n_kv_heads, head_dim, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    """An empty cache of ``max_len`` positions; under
    ``flash_decode_ctx`` this rank's shard of them, max_len / W slots."""
    fd = current_flash_decode()
    if fd is not None:
        _, world, _ = axis_group(fd.mesh, fd.axis)
        if max_len % world:
            raise ValueError(f"a sequence-sharded cache of {max_len} "
                             f"positions does not split over {world} ranks")
        max_len //= world
    shape = (batch, max_len, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def decode_softmax(q, k_cache, v_cache, lo: int, hi: int):
    """One query position against the cache slots [lo, hi): q (B, 1, H,
    hd), the caches (B, S, KH, hd) -> (B, 1, H, hd) float32, the softmax
    in float32."""
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    keys = k_cache[:, lo:hi].float()
    vals = v_cache[:, lo:hi].float()
    qg = q.reshape(b, 1, kh, h // kh, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, keys) * softmax_scale(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, vals)
    return out.reshape(b, 1, h, hd)


def _seq_sharded_over(t, axis: str) -> bool:
    """Is DTensor ``t``'s sequence (dim 1) sharded over ``axis``? An axis
    of one rank holds the whole sequence: its one shard."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    if axis not in names:
        return False
    i = names.index(axis)
    return t.placements[i] == Shard(1) or (mesh.size(i) == 1 and
                                           t.placements[i].is_replicate())


def _seq_sharded_decode_dtensor(q, k, v, cache: KVCache, slot: int, fd):
    """The flash-decode on DTensors (a cell) whose cache (B, S, K, hd) is
    sharded on its sequence over ``fd.axis`` (a cache sharded on its kv
    heads there decodes on its shards without it) and on its batch as the
    batch is; each rank runs ``seq_sharded_decode_attention`` on its shards,
    with this token's q, k, v gathered but for the batch. -> out (B, H *
    hd) float32, batch-sharded as the cache."""
    mesh = cache.k.device_mesh
    bp = tuple(p if p == Shard(0) else Replicate()
               for p in cache.k.placements)
    q, k, v = (t.redistribute(mesh, bp).to_local() for t in (q, k, v))
    out, _, _ = seq_sharded_decode_attention(
        q[:, 0], cache.k.to_local(), cache.v.to_local(), k[:, 0], v[:, 0],
        slot, mesh, axis=fd.axis)
    width = q.shape[2] * q.shape[3]
    return DTensor.from_local(out, mesh, bp, run_check=False,
                              shape=torch.Size((cache.k.shape[0], width)),
                              stride=(width, 1))


def attention_decode(p: Attention, x, cache: KVCache, *, n_heads, n_kv_heads,
                     head_dim, rope_theta, dtype=None):
    """One-token decode: x (B, 1, D) against ``cache``; returns (y (B, 1, D),
    cache with the token appended). The cache tensors are updated in place
    (the JAX package returns new arrays); only the filled prefix (its last
    ``cache.window`` slots, with a window) enters the softmax, where the
    JAX package masks the rest to exactly zero. The token sits at position
    ``cache.start + cache.length``. Under ``flash_decode_ctx`` the cache is
    this rank's shard and ``cache.length`` counts the whole sequence; that
    branch refuses a window and a ``start`` past 0, which the reference's
    branch does not know."""
    dtype = dtype or x.dtype
    b = x.shape[0]
    slot = cache.length
    pos = cache.start + slot
    fd = current_flash_decode()
    world = 1 if fd is None or isinstance(cache.k, DTensor) else \
        axis_group(fd.mesh, fd.axis)[1]
    if fd is not None and (cache.window is not None or cache.start):
        raise ValueError("the sequence-sharded decode takes neither a "
                         "window nor a cache that starts past position 0")
    if slot >= cache.k.shape[1] * world:
        raise ValueError(f"KV cache of {cache.k.shape[1] * world} positions "
                         f"is full")
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, dtype)
    cos, sin = rope_freqs(head_dim, rope_theta,
                          torch.arange(pos, pos + 1, device=x.device))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if fd is not None and isinstance(cache.k, DTensor) and \
            _seq_sharded_over(cache.k, fd.axis):
        out = _seq_sharded_decode_dtensor(q, k, v, cache, slot, fd)
        y = out.to(dtype)[:, None, :] @ weight(p.wo, dtype)
        return y, cache._replace(length=slot + 1)
    if fd is not None and not isinstance(cache.k, DTensor):
        out, _, _ = seq_sharded_decode_attention(
            q[:, 0], cache.k, cache.v, k[:, 0], v[:, 0], slot, fd.mesh,
            axis=fd.axis)
        y = out.to(dtype)[:, None, :] @ weight(p.wo, dtype)
        return y, cache._replace(length=slot + 1)
    write_slot(cache.k, slot, k[:, 0].to(cache.k.dtype))
    write_slot(cache.v, slot, v[:, 0].to(cache.v.dtype))
    lo = 0 if cache.window is None else max(0, slot + 1 - cache.window)

    def softmax_attend(q, keys, vals):
        return decode_softmax(q, keys, vals, lo, slot + 1)
    if isinstance(q, DTensor):
        out = heads_on_shards(softmax_attend, q, cache.k, cache.v)
    else:
        out = softmax_attend(q, cache.k, cache.v)
    out = heads_view(out, (b, 1, n_heads * head_dim), n_heads).to(dtype)
    return out @ weight(p.wo, dtype), cache._replace(length=slot + 1)
