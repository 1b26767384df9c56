"""Mamba-2 (SSD) block, the state-space layer of zamba2 (arXiv:2411.15242).

Counterpart of ``repro/models/mamba2.py``: in_proj -> [z gate | x | B | C
| dt]; a short causal depthwise conv over (x, B, C) with SiLU; a scalar
decay per head and position, a_t = exp(-softplus(A_log) dt_t); the SSD
core through ``chunked_linear_attention`` in ``ssm`` mode (C as q, B as k,
the dt-scaled x as v, a (B, S, H, 1) decay), so through the scan kernel on
the card; the skip D x; a gated RMSNorm; out_proj. Prefill and the long
ingest's blocks run the chunked scan, decode is one recurrent step.

The conv sums ``xp[:, i:i+S] * w[i]`` over the taps in order, in the
compute dtype, as the reference does (``F.conv1d`` would accumulate
otherwise in bf16). Softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.
Matrices are stored in the compute dtype (every use casts to it); the
norms, ``conv_b``, ``A_log``, ``dt_bias`` and ``D`` in the parameter dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.api import heads_view, shard_hidden, weight
from repro_torch.nn import RMSNorm, frozen, normal
from repro_torch.models.linear_attention import (chunked_linear_attention,
                                                 linear_attention_step)


class Mamba2Block(nn.Module):
    def __init__(self, d_model: int, *, state_dim: int = 64,
                 head_dim: int = 64, expand: int = 2, conv_width: int = 4,
                 dtype=torch.float32, param_dtype=torch.float32, gen=None,
                 device=None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        conv_ch = d_inner + 2 * state_dim         # x, B, C share the conv
        proj_out = 2 * d_inner + 2 * state_dim + n_heads

        def w(*shape, std=0.02):
            return frozen(normal(shape, std, gen=gen, dtype=dtype,
                                 device=device))

        def full(n, value):
            return frozen(torch.full((n,), value, dtype=param_dtype,
                                     device=device))

        self.norm = RMSNorm(d_model, dtype=param_dtype, device=device)
        self.in_proj = w(d_model, proj_out)
        self.conv_w = w(conv_width, conv_ch, std=0.1)
        self.conv_b = full(conv_ch, 0.0)
        self.A_log = full(n_heads, 0.0)            # softplus -> ~0.69
        self.dt_bias = full(n_heads, -2.0)
        self.D = full(n_heads, 1.0)
        self.gate_norm = RMSNorm(d_inner, dtype=param_dtype, device=device)
        self.out_proj = w(d_inner, d_model)


class Mamba2State(NamedTuple):
    ssm: torch.Tensor      # (B, H, N, head_dim) float32
    conv: torch.Tensor     # (B, K - 1, conv_ch) compute dtype


def init_mamba2_state(batch, d_model, *, state_dim=64, head_dim=64, expand=2,
                      conv_width=4, dtype=torch.float32,
                      device=None) -> Mamba2State:
    d_inner = expand * d_model
    h = d_inner // head_dim
    return Mamba2State(
        ssm=torch.zeros((batch, h, state_dim, head_dim), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, conv_width - 1, d_inner + 2 * state_dim),
                         dtype=dtype, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p: Mamba2Block, xn, d_model, state_dim, expand, dtype):
    d_inner = expand * d_model
    proj = xn @ weight(p.in_proj, dtype)
    z, xbc, dt = torch.split(
        proj, [d_inner, d_inner + 2 * state_dim,
               proj.shape[-1] - 2 * d_inner - 2 * state_dim], dim=-1)
    return z, xbc, dt, d_inner


def _causal_depthwise_conv(xbc, w, b, *, carry=None):
    """xbc (B, S, C); w (K, C). Causal depthwise conv then SiLU; ``carry``
    (B, K - 1, C): the previous inputs. Returns (out, new carry)."""
    kw, s = w.shape[0], xbc.shape[1]
    pad = carry if carry is not None else xbc.new_zeros(
        (xbc.shape[0], kw - 1, xbc.shape[-1]))
    xp = torch.cat([pad, xbc], dim=1)
    out = xp[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, kw):
        out = out + xp[:, i:i + s] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype)), xp[:, xp.shape[1] - (kw - 1):]


def _mamba2_seq(p: Mamba2Block, x, *, state_dim, head_dim, expand, chunk,
                dtype, conv_carry=None, initial_state=None):
    """The block over a sequence -> (out, final SSM state, conv carry)."""
    b, s, d_model = x.shape
    z, xbc, dt, d_inner = _split_proj(p, p.norm(x), d_model, state_dim,
                                      expand, dtype)
    n_heads = d_inner // head_dim
    xbc, new_conv = _causal_depthwise_conv(xbc, p.conv_w, p.conv_b,
                                           carry=conv_carry)
    xs, bmat, cmat = torch.split(xbc, [d_inner, state_dim, state_dim],
                                 dim=-1)
    xs = shard_hidden(xs, "batch", None, "ffn")
    dt = _softplus(dt.float() + p.dt_bias.float())           # (B, S, H)
    log_decay = -_softplus(p.A_log.float()) * dt
    xh = heads_view(xs, (b, s, n_heads, head_dim), n_heads)
    v = (xh.float() * dt[..., None]).to(dtype)
    # B and C are shared across the heads (one group): broadcast
    k = bmat[:, :, None, :].expand(b, s, n_heads, state_dim)
    q = cmat[:, :, None, :].expand(b, s, n_heads, state_dim)
    y, state = chunked_linear_attention(
        q, k, v, log_decay[..., None], chunk=chunk, mode="ssm",
        per_channel=False, initial_state=initial_state)
    y = y.to(dtype) + weight(p.D, dtype)[None, None, :, None] * xh
    y = p.gate_norm(heads_view(y, (b, s, d_inner), n_heads)) * F.silu(z)
    return x + y @ weight(p.out_proj, dtype), state, new_conv


def mamba2_block(p: Mamba2Block, x, *, state_dim: int = 64,
                 head_dim: int = 64, expand: int = 2, chunk: int = 128,
                 dtype=None, initial_state=None, return_state: bool = False):
    """x (B, S, D) -> out (and the final SSM state with ``return_state``)."""
    out, state, _ = _mamba2_seq(p, x, state_dim=state_dim, head_dim=head_dim,
                                expand=expand, chunk=chunk,
                                dtype=dtype or x.dtype,
                                initial_state=initial_state)
    return (out, state) if return_state else out


def mamba2_block_chunk(p: Mamba2Block, x, state: Mamba2State, *,
                       state_dim=64, head_dim=64, expand=2, chunk: int = 128,
                       dtype=None):
    """The block over one segment of a long sequence, carrying ``state``;
    chained segments equal one pass. -> (out, new state)."""
    out, ssm, conv = _mamba2_seq(p, x, state_dim=state_dim,
                                 head_dim=head_dim, expand=expand,
                                 chunk=chunk, dtype=dtype or x.dtype,
                                 conv_carry=state.conv,
                                 initial_state=state.ssm)
    return out, Mamba2State(ssm=ssm, conv=conv)


def mamba2_block_step(p: Mamba2Block, x, state: Mamba2State, *,
                      state_dim=64, head_dim=64, expand=2, dtype=None):
    """One decode token, x (B, D) -> (out (B, D), new state)."""
    dtype = dtype or x.dtype
    b, d_model = x.shape
    z, xbc, dt, d_inner = _split_proj(p, p.norm(x[:, None, :]), d_model,
                                      state_dim, expand, dtype)
    n_heads = d_inner // head_dim
    xbc, new_conv = _causal_depthwise_conv(xbc, p.conv_w, p.conv_b,
                                           carry=state.conv)
    xs, bmat, cmat = torch.split(xbc[:, 0], [d_inner, state_dim, state_dim],
                                 dim=-1)
    dt1 = _softplus(dt[:, 0].float() + p.dt_bias.float())    # (B, H)
    log_decay = -_softplus(p.A_log.float()) * dt1
    xh = xs.reshape(b, n_heads, head_dim)
    v = xh.float() * dt1[..., None]
    k = bmat[:, None, :].expand(b, n_heads, state_dim)
    q = cmat[:, None, :].expand(b, n_heads, state_dim)
    y, new_ssm = linear_attention_step(q, k, v, log_decay[..., None],
                                       state.ssm, mode="ssm")
    y = y.to(dtype) + weight(p.D, dtype)[None, :, None] * xh
    y = p.gate_norm(y.reshape(b, d_inner)) * F.silu(z[:, 0])
    return x + y @ weight(p.out_proj, dtype), Mamba2State(ssm=new_ssm,
                                                     conv=new_conv)
