"""Collectives over one axis of a DeviceMesh: the sequence-sharded
flash-decode, ``ppermute`` and the narrow-code ring sum.

Counterpart of ``repro/distributed/collectives.py``, with
``torch.distributed`` in place of ``shard_map``: each rank of the mesh's
``axis`` runs the per-shard function, and ``pmax``/``psum`` become
``all_reduce`` over that axis's process group.

Flash-decode: when kv_heads does not divide the model axis (qwen2-7b: 4 kv
heads), the KV cache is sharded over the sequence. Each rank holds S/W
slots; only the rank whose shard covers position ``length`` writes the new
token, in place; each rank forms a float32 partial softmax over its own
filled slots, and the partials merge with one max and one sum all-reduce
of O(B·H·hd) floats. The cache never leaves its rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import softmax_scale

NEG_INF = -1e30


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) of ``axis`` of ``mesh``."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)


def ppermute(t: torch.Tensor, perm, group) -> torch.Tensor:
    """``jax.lax.ppermute``: for each (src, dst) of ``perm`` (ranks of
    ``group``), dst receives src's ``t``; a rank that receives nothing
    gets zeros. A pair (i, i) is a copy, with no collective; the others go
    through one ``batch_isend_irecv``."""
    me = dist.get_rank(group)
    out = torch.zeros_like(t)
    ops = []
    for src, dst in perm:
        if src == dst == me:
            out.copy_(t)
        elif src == me and dst != src:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  dist.get_global_rank(group, dst), group))
        elif dst == me and dst != src:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def ring_sum(codes: torch.Tensor, group) -> torch.Tensor:
    """The int32 sum over ``group`` of every rank's narrow ``codes``.

    The reference passes the narrow codes round a ring of W - 1
    ``ppermute``s and adds each to an int32 accumulator. Here they go out
    through one ``all_gather`` and are summed in int32: each rank receives
    the same W - 1 narrow tensors, and integer sums are exact in any order,
    so the result is bit-identical. The codes go out as their bytes
    (uint8), still bits/8 bytes a code. With one rank there is nothing to
    receive and no collective."""
    acc = codes.to(torch.int32)
    world = dist.get_world_size(group)
    if world == 1:
        return acc
    me = dist.get_rank(group)
    # the codes' bytes travel as uint8: gloo takes no int16 collective
    wire = codes.contiguous().reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(bufs, wire, group=group)
    for i, buf in enumerate(bufs):
        if i != me:
            acc += buf.view(codes.dtype).reshape(codes.shape).to(torch.int32)
    return acc


def _local_update(cache: torch.Tensor, new: torch.Tensor, length: int,
                  idx: int, s_local: int) -> None:
    """Write ``new`` (B, K, hd) at global position ``length``, in place, if
    this rank's shard covers it."""
    pos = length - idx * s_local
    if 0 <= pos < s_local:
        cache[:, pos] = new.to(cache.dtype)


def _partial_attention(q, k, v, length: int, idx: int, s_local: int,
                       group) -> torch.Tensor:
    """q (B, H, hd); k/v (B, S_loc, K, hd), this rank's shard. The partial
    softmax over the shard's slots at positions <= ``length``, merged
    across the group -> (B, H * hd) float32."""
    b, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    n = min(max(length + 1 - idx * s_local, 0), s_local)
    qg = q.reshape(b, kh, g, hd).float()
    if n:
        scores = torch.einsum("bkgh,bskh->bkgs", qg, k[:, :n].float()) \
            * softmax_scale(hd)
        m_loc = scores.amax(-1)                                 # (B, K, g)
        p = torch.exp(scores - m_loc[..., None])
        l_loc = p.sum(-1)
        o_loc = torch.einsum("bkgs,bskh->bkgh", p, v[:, :n].float())
    else:                                  # nothing filled in this shard
        m_loc = torch.full((b, kh, g), NEG_INF, device=q.device)
        l_loc = torch.zeros((b, kh, g), device=q.device)
        o_loc = torch.zeros((b, kh, g, hd), device=q.device)
    m_glob = m_loc.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m_glob)
    lo = torch.cat([o_loc * corr[..., None], (l_loc * corr)[..., None]], -1)
    dist.all_reduce(lo, op=dist.ReduceOp.SUM, group=group)
    out = lo[..., :hd] / lo[..., hd:].clamp_min(1e-20)
    return out.reshape(b, h * hd)


def seq_sharded_decode_attention(q, cache_k, cache_v, new_k, new_v,
                                 length: int, mesh, *, axis: str = "model"):
    """One-token attention against a sequence-sharded KV cache.

    q: (B, H, hd), this token's query (RoPE applied), the same on every
    rank of ``axis``. cache_k/v: (B, S / W, K, hd), this rank's shard of
    the cache (slots [rank * S / W, (rank + 1) * S / W)), updated in
    place. new_k/v: (B, K, hd), this token's keys and values. ``length``:
    the tokens already in the cache (the new token's position).
    Returns (out (B, H * hd) float32, cache_k, cache_v).
    """
    group, _, idx = axis_group(mesh, axis)
    s_local = cache_k.shape[1]
    _local_update(cache_k, new_k, length, idx, s_local)
    _local_update(cache_v, new_v, length, idx, s_local)
    out = _partial_attention(q, cache_k, cache_v, length, idx, s_local, group)
    return out, cache_k, cache_v
