"""RWKV-6 (Finch) block, arXiv:2404.05892.

Counterpart of ``repro/models/rwkv6.py``: time mixing with the
data-dependent token-shift lerp (DDLerp, low rank, five mixes), the
data-dependent per-channel decay w_t = exp(-exp(w0 + lora(x))), the
per-head bonus u and the wkv recurrence (``models/linear_attention.py``,
the linear-scan kernel on the card); channel mixing is the squared-ReLU
token-shift MLP. Prefill and long ingest run the chunked scan, decode is
O(1) per token.

As in the JAX package: ``w0`` and the decay LoRA are added in float32
before ``-exp``; ``ln_x`` is a LayerNorm over the whole d_model; r, k and v
are in the compute dtype and the scan widens them to float32. Weights that
every use casts to the compute dtype are stored in it; the norms, ``w0``
and ``u`` stay float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.api import heads_view, shard_hidden, weight
from repro_torch.nn import LayerNorm, frozen, normal
from repro_torch.models.linear_attention import (chunked_linear_attention,
                                                 linear_attention_step)

N_MIX = 5              # r, k, v, g, w


class RWKV6Block(nn.Module):
    def __init__(self, d_model: int, head_dim: int, *, lora_rank: int = 64,
                 mix_rank: int = 32, d_ff: int | None = None,
                 dtype=torch.float32, param_dtype=torch.float32, gen=None,
                 device=None):
        super().__init__()
        d_ff = d_ff or d_model * 7 // 2
        n_heads = d_model // head_dim

        def w(*shape, std=0.02, dt=dtype):
            return frozen(normal(shape, std, gen=gen, dtype=dt, device=device))

        def full(shape, value, dt=dtype):
            return frozen(torch.full(shape, value, dtype=dt, device=device))

        self.ln1 = LayerNorm(d_model, dtype=param_dtype, device=device)
        self.ln2 = LayerNorm(d_model, dtype=param_dtype, device=device)
        self.mu_x = full((d_model,), 0.0)
        self.mu_base = full((N_MIX, d_model), 0.0)
        self.mix_w1 = w(d_model, N_MIX * mix_rank)
        self.mix_w2 = w(N_MIX, mix_rank, d_model)
        self.wr = w(d_model, d_model)
        self.wk = w(d_model, d_model)
        self.wv = w(d_model, d_model)
        self.wg = w(d_model, d_model)
        self.wo = w(d_model, d_model)
        self.w0 = full((d_model,), -1.0, param_dtype)   # resting log(-log w)
        self.wd_a = w(d_model, lora_rank)
        self.wd_b = w(lora_rank, d_model)
        self.u = w(n_heads, head_dim, std=0.1, dt=param_dtype)
        self.ln_x = LayerNorm(d_model, dtype=param_dtype, device=device)
        self.cm_mu_k = full((d_model,), 0.5)
        self.cm_mu_r = full((d_model,), 0.5)
        self.cm_wk = w(d_model, d_ff)
        self.cm_wv = w(d_ff, d_model)
        self.cm_wr = w(d_model, d_model)


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None):
    """x[t] -> x[t-1]; the first position takes ``last`` (the carry) or 0."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: RWKV6Block, x, dx, dtype):
    """Data-dependent lerp: the five mixed inputs (r, k, v, g, w)."""
    xxx = x + dx * weight(p.mu_x, dtype)
    lora = torch.tanh(xxx @ weight(p.mix_w1, dtype))
    b, s, _ = x.shape
    lora = heads_view(lora, (b, s, N_MIX, -1), N_MIX)
    mus = weight(p.mu_base, dtype) + torch.einsum(
        "bsfr,frd->bsfd", lora, weight(p.mix_w2, dtype))
    return [x + dx * mus[:, :, i, :] for i in range(N_MIX)]


def _time_mix_qkvgw(p: RWKV6Block, x, dx, n_heads, head_dim, dtype):
    b, s, _ = x.shape
    xr, xk, xv, xg, xw = _ddlerp(p, x, dx, dtype)
    shape = (b, s, n_heads, head_dim)
    r = heads_view(xr @ weight(p.wr, dtype), shape, n_heads)
    k = heads_view(xk @ weight(p.wk, dtype), shape, n_heads)
    v = heads_view(xv @ weight(p.wv, dtype), shape, n_heads)
    g = F.silu(xg @ weight(p.wg, dtype))
    dd = torch.tanh(xw @ weight(p.wd_a, dtype)) @ weight(p.wd_b, dtype)
    log_decay = -torch.exp(p.w0.to(torch.float32) + dd.to(torch.float32))
    return r, k, v, g, heads_view(log_decay, shape, n_heads)


def _time_mix_out(p: RWKV6Block, wkv, g, b, s, d, dtype):
    y = p.ln_x(heads_view(wkv, (b, s, d), wkv.shape[2]).to(dtype))
    return (y * g) @ weight(p.wo, dtype)


def _channel_mix(p: RWKV6Block, xn, dx, dtype, *, seq: bool = False):
    xk = xn + dx * weight(p.cm_mu_k, dtype)
    xr = xn + dx * weight(p.cm_mu_r, dtype)
    kv = torch.relu(xk @ weight(p.cm_wk, dtype)).square()
    if seq:
        kv = shard_hidden(kv, "batch", None, "ffn")
    kv = kv @ weight(p.cm_wv, dtype)
    return torch.sigmoid(xr @ weight(p.cm_wr, dtype)) * kv


def rwkv6_time_mix(p: RWKV6Block, x, *, head_dim: int, chunk: int = 16,
                   dtype=None):
    dtype = dtype or x.dtype
    b, s, d = x.shape
    dx = _token_shift(x) - x
    r, k, v, g, log_decay = _time_mix_qkvgw(p, x, dx, d // head_dim,
                                            head_dim, dtype)
    wkv, _ = chunked_linear_attention(r, k, v, log_decay, bonus=p.u,
                                      chunk=chunk, mode="rwkv")
    return _time_mix_out(p, wkv.to(dtype), g, b, s, d, dtype)


def rwkv6_channel_mix(p: RWKV6Block, x, *, dtype=None):
    dtype = dtype or x.dtype
    return _channel_mix(p, x, _token_shift(x) - x, dtype, seq=True)


def rwkv6_block(p: RWKV6Block, x, *, head_dim: int, chunk: int = 16,
                dtype=None):
    y = x + rwkv6_time_mix(p, p.ln1(x), head_dim=head_dim, chunk=chunk,
                           dtype=dtype)
    return y + rwkv6_channel_mix(p, p.ln2(y), dtype=dtype)


# ---------------------------------------------------------------------------
# Recurrent state: the wkv state and the two token-shift carries
# ---------------------------------------------------------------------------

class RWKV6State(NamedTuple):
    wkv: torch.Tensor        # (B, H, dk, dv) float32
    last_tm: torch.Tensor    # (B, D) token-shift carry, time mixing
    last_cm: torch.Tensor    # (B, D) token-shift carry, channel mixing


def init_rwkv6_state(batch, d_model, head_dim, dtype=torch.float32,
                     device=None) -> RWKV6State:
    h = d_model // head_dim
    return RWKV6State(
        wkv=torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32,
                        device=device),
        last_tm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        last_cm=torch.zeros((batch, d_model), dtype=dtype, device=device))


def rwkv6_block_chunk(p: RWKV6Block, x, state: RWKV6State, *, head_dim: int,
                      chunk: int = 16, dtype=None):
    """Stateful block over one segment x (B, L, D) of a long sequence:
    ``state`` carries the wkv state and the previous segment's last token
    for both token shifts, so chained segments equal one full pass."""
    dtype = dtype or x.dtype
    b, s, d = x.shape
    xn = p.ln1(x)
    dx = _token_shift(xn, last=state.last_tm) - xn
    r, k, v, g, log_decay = _time_mix_qkvgw(p, xn, dx, d // head_dim,
                                            head_dim, dtype)
    wkv, new_wkv = chunked_linear_attention(
        r, k, v, log_decay, bonus=p.u, chunk=chunk, mode="rwkv",
        initial_state=state.wkv)
    y = x + _time_mix_out(p, wkv.to(dtype), g, b, s, d, dtype)
    yn = p.ln2(y)
    y = y + _channel_mix(p, yn, _token_shift(yn, last=state.last_cm) - yn,
                         dtype)
    return y, RWKV6State(wkv=new_wkv, last_tm=xn[:, -1], last_cm=yn[:, -1])


def rwkv6_block_step(p: RWKV6Block, x, state: RWKV6State, *, head_dim: int,
                     dtype=None):
    """One token x (B, D) -> (y (B, D), new state)."""
    dtype = dtype or x.dtype
    b, d = x.shape
    xn = p.ln1(x[:, None, :])
    dx = state.last_tm[:, None, :] - xn
    r, k, v, g, log_decay = _time_mix_qkvgw(p, xn, dx, d // head_dim,
                                            head_dim, dtype)
    wkv, new_wkv = linear_attention_step(
        r[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], state.wkv, bonus=p.u,
        mode="rwkv")
    y = x + _time_mix_out(p, wkv[:, None].to(dtype), g, b, 1, d, dtype)[:, 0]
    yn = p.ln2(y[:, None, :])
    y = y + _channel_mix(p, yn, state.last_cm[:, None, :] - yn, dtype)[:, 0]
    return y, RWKV6State(wkv=new_wkv, last_tm=xn[:, 0], last_cm=yn[:, 0])
