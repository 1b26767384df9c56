"""Chunked linear-attention / SSM scan: the sub-quadratic engine of RWKV-6
(per-channel data-dependent decay and a bonus) and Mamba-2 (scalar decay).

Counterpart of ``repro/models/linear_attention.py``. Per head, with state
S_t of shape (dk, dv):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    rwkv mode:  y_t = q_t . S_{t-1} + (q_t * u * k_t) . v_t   (bonus u)
    ssm  mode:  y_t = q_t . S_t                                (self included)

``chunked_linear_attention`` goes through the scan wrapper
(``kernels/linear_scan.py``): the kernel for a CUDA tensor, the chunked
algorithm in plain torch for a CPU tensor. ``linear_attention_step`` is the
one-token recurrence of decode and ``reference_scan`` the O(S) recurrent
oracle the tests hold the chunked forms against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan import (LOG_DECAY_MAX, LOG_DECAY_MIN,
                                             linear_scan)


def chunked_linear_attention(q, k, v, log_decay, *, bonus=None,
                             chunk: int = 16, initial_state=None,
                             per_channel: bool = True, mode: str = "rwkv"):
    """q, k (B, S, H, dk); v (B, S, H, dv); log_decay (B, S, H, dk) or
    (B, S, H, 1); bonus (H, dk) (rwkv only). Returns (y (B, S, H, dv),
    final_state (B, H, dk, dv)), both float32. Only forwards to
    ``linear_scan``; kept so that the model code and the tests name the
    function as the JAX module does. ``per_channel`` is accepted and
    ignored, as by the JAX package's kernel path: the decay's last dim (dk
    or 1) says which it is."""
    return linear_scan(q, k, v, log_decay, bonus=bonus,
                       initial_state=initial_state, chunk=chunk, mode=mode)


def linear_attention_step(q, k, v, log_decay, state, *, bonus=None,
                          mode: str = "rwkv"):
    """One recurrent step for decode. q, k (B, H, dk); v (B, H, dv);
    log_decay (B, H, dk) or (B, H, 1); state (B, H, dk, dv)."""
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(torch.clamp(log_decay.to(f32), LOG_DECAY_MIN, LOG_DECAY_MAX))
    kv = k[..., :, None] * v[..., None, :]
    if mode == "rwkv":
        y = torch.einsum("bhd,bhdv->bhv", q, state)
        if bonus is not None:
            y = y + torch.einsum("bhd,hd,bhd->bh", q, bonus.to(f32),
                                 k)[..., None] * v
        new_state = w[..., None] * state + kv
    else:
        new_state = w[..., None] * state + kv
        y = torch.einsum("bhd,bhdv->bhv", q, new_state)
    return y, new_state


def reference_scan(q, k, v, log_decay, *, bonus=None, initial_state=None,
                   mode: str = "rwkv"):
    """O(S) recurrent oracle: ``linear_attention_step`` over every position."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(s):
        y, state = linear_attention_step(q[:, t], k[:, t], v[:, t],
                                         log_decay[:, t], state, bonus=bonus,
                                         mode=mode)
        ys.append(y)
    return torch.stack(ys, dim=1), state
