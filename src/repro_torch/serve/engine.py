"""Serving steps: prefill, one-token decode, and chunked long-context
ingestion for the ssm and hybrid families.

Counterpart of ``repro/serve/engine.py``. The audio family (whisper)
prefills through ``encode`` then the teacher-forced ``decode_train`` and
decodes with ``encdec_decode_step``; the others through the LM.

Long-context ingestion walks the sequence in blocks so that activation
memory is O(block), not O(S): per block, embed -> every layer's chunked
block carrying its recurrent state (rwkv: the wkv state and the two
token-shift carries; zamba2: the SSM state and the conv carry) -> the next
block. For zamba2 the shared attention block, after each segment of
Mamba-2 layers, attends over a window of ``block`` positions: the block's
own keys and the previous block's, carried per segment. So the ingest
equals a prefill with ``window=block``; the long-context config sets
``attn_window_long`` to the block. The ingest returns the last token's
logits and the states, ready to decode at position S.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.api import (heads_on_shards, heads_view,
                                         lookup, shard_hidden, weight)
from repro_torch.kernels.flash_attention import softmax_scale
from repro_torch.models.attention import KVCache, apply_rope, rope_freqs
from repro_torch.models.encdec import decode_train, encdec_decode_step, encode
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.lm import (LM, AttnBlock, DecodeCache, check_family,
                                   lm_decode_step, lm_forward, lm_logits,
                                   segment_bounds)
from repro_torch.models.mamba2 import init_mamba2_state, mamba2_block_chunk
from repro_torch.models.rwkv6 import init_rwkv6_state, rwkv6_block_chunk

# kv heads per slice of the windowed shared attention's float32 scores:
# (B, 8, W, 2W) floats, 2.1 GB at zamba2's W = 4096 and B = 2
SHARED_ATTN_KV_HEADS = 8


def make_prefill_step(cfg: ArchConfig):
    """-> prefill(model, batch) -> logits (B, S, V); batch holds ``tokens``
    (B, S) or ``embeds`` (B, S, D); for audio ``audio_embeds`` (B, S_enc,
    D) and the decoder's ``tokens``."""
    if cfg.family == "audio":
        @torch.no_grad()
        def prefill_audio(model, batch: dict):
            enc_out = encode(model, batch["audio_embeds"])
            return decode_train(model, batch["tokens"], enc_out)
        return prefill_audio
    check_family(cfg)

    @torch.no_grad()
    def prefill(model: LM, batch: dict):
        logits, _ = lm_forward(model, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))
        return logits
    return prefill


def make_decode_step(cfg: ArchConfig):
    """-> step(model, cache, token) -> (logits (B, V), new cache)."""
    if cfg.family == "audio":
        return encdec_decode_step
    check_family(cfg)

    def step(model: LM, cache, token):
        return lm_decode_step(model, cache, token)
    return step


class LongState(NamedTuple):
    layer_states: list               # [RWKV6State] or [Mamba2State]
    shared_k: Optional[list] = None  # zamba2: (B, W, KH, hd) per segment
    shared_v: Optional[list] = None
    block_idx: int = 0


def _check_long(cfg: ArchConfig) -> None:
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError("long ingestion is sub-quadratic only (ssm/hybrid)")


def init_long_state(cfg: ArchConfig, batch: int, block: int,
                    device=None) -> LongState:
    _check_long(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return LongState(layer_states=[
            init_rwkv6_state(batch, cfg.d_model, cfg.ssm.head_dim, cfg.dtype,
                             device=dev) for _ in range(cfg.n_layers)])
    states = [init_mamba2_state(batch, cfg.d_model,
                                state_dim=cfg.ssm.state_dim,
                                head_dim=cfg.ssm.head_dim,
                                expand=cfg.ssm.expand,
                                conv_width=cfg.ssm.conv_width,
                                dtype=cfg.dtype, device=dev)
              for _ in range(cfg.n_layers)]
    nseg = len(segment_bounds(cfg))
    shape = (batch, block, cfg.n_kv_heads, cfg.hd)

    def zeros():
        return [torch.zeros(shape, dtype=cfg.dtype, device=dev)
                for _ in range(nseg)]
    return LongState(layer_states=states, shared_k=zeros(), shared_v=zeros())


def _shared_attn_windowed(lp: AttnBlock, cfg: ArchConfig, x, prev_k, prev_v,
                          positions, first_block: bool):
    """The shared zamba2 block over one block of W positions, its keys the
    previous block's (``prev_k``/``prev_v``) and its own, each query seeing
    the last W positions -> (x, k, v). Plain einsum and softmax in float32
    as in the reference, computed SHARED_ATTN_KV_HEADS kv heads at a time
    (the same arithmetic per head)."""
    dtype = cfg.dtype
    b, w, _ = x.shape
    kh, hd = cfg.n_kv_heads, cfg.hd
    xn = lp.ln1(x)
    q = heads_view(xn @ weight(lp.attn.wq, dtype), (b, w, cfg.n_heads, hd),
                   cfg.n_heads)
    k = heads_view(xn @ weight(lp.attn.wk, dtype), (b, w, kh, hd), kh)
    v = heads_view(xn @ weight(lp.attn.wv, dtype), (b, w, kh, hd), kh)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    k2 = torch.cat([prev_k, k], dim=1)                      # (B, 2W, KH, hd)
    v2 = torch.cat([prev_v, v], dim=1)
    qpos = torch.arange(w, device=x.device)[:, None] + w
    kpos = torch.arange(2 * w, device=x.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)
    if first_block:
        mask = mask & (kpos >= w)

    def attend(q, k2, v2):
        b, h, kh = q.shape[0], q.shape[2], k2.shape[2]
        qg = q.reshape(b, w, kh, h // kh, hd)
        out = torch.empty((b, w, kh, h // kh, hd), dtype=torch.float32,
                          device=q.device)
        for h0 in range(0, kh, SHARED_ATTN_KV_HEADS):
            hs = slice(h0, h0 + SHARED_ATTN_KV_HEADS)
            scores = torch.einsum("bqkgh,bskh->bkgqs", qg[:, :, hs].float(),
                                  k2[:, :, hs].float()) * softmax_scale(hd)
            scores = scores.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            del scores
            out[:, :, hs] = torch.einsum("bkgqs,bskh->bqkgh", probs,
                                         v2[:, :, hs].float())
            del probs
        return out.reshape(b, w, h, hd)
    if isinstance(q, DTensor):
        out = heads_on_shards(attend, q, k2, v2)
    else:
        out = attend(q, k2, v2)
    out = heads_view(out, (b, w, cfg.n_heads * hd), cfg.n_heads).to(dtype)
    x = x + out @ weight(lp.attn.wo, dtype)
    x = x + ffn_apply(lp.ffn, lp.ln2(x), dtype=dtype)
    return x, k, v


def make_long_ingest(cfg: ArchConfig, *, block: int = 8192):
    """-> ingest(model, tokens (B, S)) -> (last-token logits (B, V),
    LongState). S must be a multiple of ``block``; for zamba2 the shared
    block's window is ``block`` (set ``attn_window_long`` to it)."""
    _check_long(cfg)

    @torch.no_grad()
    def ingest(model: LM, tokens: torch.Tensor):
        b, s = tokens.shape
        if s == 0 or s % block:
            raise ValueError(f"sequence {s} is not a positive multiple of "
                             f"block {block}")
        st = init_long_state(cfg, b, block, device=model.device)
        states, sk, sv = st.layer_states, st.shared_k, st.shared_v
        for i in range(s // block):
            x = lookup(model.embed,
                       tokens[:, i * block:(i + 1) * block]).to(cfg.dtype)
            x = shard_hidden(x, "batch", None, "act_hidden")
            if cfg.family == "ssm":
                states = [None] * cfg.n_layers
                for j, (lp, lst) in enumerate(zip(model.layers,
                                                  st.layer_states)):
                    x, states[j] = rwkv6_block_chunk(
                        lp, x, lst, head_dim=cfg.ssm.head_dim,
                        chunk=cfg.ssm.chunk, dtype=cfg.dtype)
            else:
                positions = torch.arange(i * block, (i + 1) * block,
                                         device=x.device)
                states = list(st.layer_states)
                sk, sv = list(st.shared_k), list(st.shared_v)
                for seg, (lo, hi) in enumerate(segment_bounds(cfg)):
                    for j in range(lo, hi):
                        x, states[j] = mamba2_block_chunk(
                            model.layers[j], x, states[j],
                            state_dim=cfg.ssm.state_dim,
                            head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand,
                            chunk=cfg.ssm.chunk, dtype=cfg.dtype)
                    x, sk[seg], sv[seg] = _shared_attn_windowed(
                        model.shared, cfg, x, sk[seg], sv[seg], positions,
                        first_block=i == 0)
            st = LongState(layer_states=states, shared_k=sk, shared_v=sv,
                           block_idx=i + 1)
        # the JAX package takes every block's last logits and keeps the
        # final block's; only that one is computed here
        logits = lm_logits(model, model.final_norm(x[:, -1:, :]))[:, 0]
        return logits, st

    return ingest


def decode_cache_from_ingest(cfg: ArchConfig, state: LongState,
                             extra: int) -> DecodeCache:
    """The decode cache that continues a long ingest for ``extra`` tokens.
    rwkv: its states. zamba2: its Mamba-2 states, and for each shared-block
    call a KV cache seeded with the last W - 1 keys of the ingest's window
    carry (positions S - W + 1 .. S - 1) that attends the last W positions,
    so each decode step equals a prefill with ``window=W`` at its position
    (W = the ingest's block). The JAX package defines no decode after a
    hybrid ingest; this is the long-context mode's attention continued."""
    _check_long(cfg)
    if cfg.family == "ssm":
        return DecodeCache(rwkv=list(state.layer_states))
    kvs = []
    for k, v in zip(state.shared_k, state.shared_v):
        b, w = k.shape[:2]
        pad = k.new_zeros((b, extra) + k.shape[2:])
        s = state.block_idx * w
        kvs.append(KVCache(k=torch.cat([k[:, 1:], pad], dim=1),
                           v=torch.cat([v[:, 1:], pad], dim=1),
                           length=w - 1, start=s - w + 1, window=w))
    return DecodeCache(ssm=list(state.layer_states), shared_kv=kvs)
