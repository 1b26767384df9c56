"""Flash attention with GQA: the wrapper and its plain torch version.

``flash_attention`` is the counterpart of ``repro/kernels/ops.py::
flash_attention`` (GQA) around ``flash_attention_pallas``: a CUDA tensor
goes through the kernel in ``csrc/flash_attention.cu`` (or the call
raises); a CPU tensor goes through ``flash_attention_plain``, the
counterpart of ``repro/kernels/ref.py::flash_attention_ref``. The kernel
takes every ``Sq``/``Sk`` (it masks the ragged edge itself), reads the
(B, S, H, hd) inputs through their strides and maps query head ``h`` to kv
head ``h // (H // KH)``, so no repeat and no transpose is made. bf16 runs
on the tensor cores (wgmma) and needs 16-byte-aligned bases and strides;
the call raises on others. float32 runs on the tensor cores too (mma.sync
in 3xTF32: a TF32 high part and a remainder per operand, float32's
accuracy) and takes any base and strides.

Gradients: with grad mode on and q, k or v requiring grad, a CUDA call goes
through ``_FlashAttention``, a ``torch.autograd.Function`` whose forward is
the same launch and whose backward is :func:`flash_attention_backward`, the
gradient of the same function in plain torch from the saved q, k, v. The
JAX package has no backward kernel (no ``custom_vjp`` around its Pallas
call: XLA differentiates its reference path), so there is none here.

Two more routes serve the cells (``launch.specs``):
  DTensor  q, k, v are redistributed so that the function is local (batch
           and heads sharded, sequence and head dim replicated; the kv
           heads sharded with their query group, or repeated to the query
           heads first where the mesh axis does not divide both head
           counts, as the reference repeats them before its sharding
           constraint), and each rank runs the wrapper on its shards.
  meta     the wrapper charges its cost (``launch.hlo_cost.charged``) and
           returns an empty meta output: the dry run runs nothing.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed.api import heads_on_shards
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernel's instantiations
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded as float32 arithmetic rounds it (IEEE sqrt,
    then divide), as a Python float: multiplying by it costs no copy to the
    device, and the kernel uses the same value."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def attention_mask(first_pos: int, n: int, sk: int, *, causal: bool,
                   window: int | None, device=None) -> torch.Tensor:
    """(n, Sk) bool: does query i, at position ``first_pos + i``, see key j?"""
    qpos = first_pos + torch.arange(n, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((n, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset: int | None = None) -> torch.Tensor:
    """Full-softmax attention in float32: q (B, Sq, H, hd), k/v (B, Sk, KH,
    hd) with KH | H -> (B, Sq, H, hd) in q's dtype. The kv heads are
    repeated (``repeat_interleave``: kv head j serves q heads j*g..j*g+g-1)
    as ``ops.flash_attention`` does before the reference. Query i sits at
    position i + ``q_offset`` (default ``Sk - Sq``); a row that sees no key
    is NaN, as in the reference."""
    h, hd = q.shape[2], q.shape[3]
    sq, sk, kh = q.shape[1], k.shape[1], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) \
        * softmax_scale(hd)
    mask = attention_mask(sk - sq if q_offset is None else q_offset, sq, sk,
                          causal=causal, window=window, device=q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.float())
    return out.to(q.dtype)


_BACKWARD_Q_BLOCK = 1024      # query rows a step of the plain backward


def flash_attention_backward(q, k, v, dout, *, causal: bool = True,
                             window: int | None = None):
    """The gradient of :func:`flash_attention_plain` with respect to q, k
    and v at the cotangent ``dout`` (B, Sq, H, hd), in plain torch and
    float32, each returned in its input's dtype. With P the softmax of the
    masked, scaled scores and dP = dO V^T: dV = P^T dO, dS = P (dP -
    rowsum(P dP)), dQ = scale dS K, dK = scale dS^T Q; a kv head's dK and
    dV sum over the q heads that share it. The scores are recomputed
    _BACKWARD_Q_BLOCK query rows at a time, so the buffers are that many
    rows of Sk per head."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = softmax_scale(hd)
    f32 = torch.float32
    kf = k.to(f32).repeat_interleave(g, dim=2)          # (B, Sk, H, hd)
    vf = v.to(f32).repeat_interleave(g, dim=2)
    dk = torch.zeros((b, sk, h, hd), dtype=f32, device=q.device)
    dv = torch.zeros((b, sk, h, hd), dtype=f32, device=q.device)
    dq = []
    for start in range(0, sq, _BACKWARD_Q_BLOCK):
        qb = q[:, start:start + _BACKWARD_Q_BLOCK].to(f32)
        dob = dout[:, start:start + _BACKWARD_Q_BLOCK].to(f32)
        scores = torch.einsum("bqhd,bshd->bhqs", qb, kf) * scale
        mask = attention_mask(sk - sq + start, qb.shape[1], sk,
                              causal=causal, window=window, device=q.device)
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        dv += torch.einsum("bhqs,bqhd->bshd", probs, dob)
        dp = torch.einsum("bqhd,bshd->bhqs", dob, vf)
        ds = probs * (dp - (probs * dp).sum(-1, keepdim=True)) * scale
        dq.append(torch.einsum("bhqs,bshd->bqhd", ds, kf))
        dk += torch.einsum("bhqs,bqhd->bshd", ds, qb)
    dk = dk.reshape(b, sk, kh, g, hd).sum(3)
    dv = dv.reshape(b, sk, kh, g, hd).sum(3)
    return (torch.cat(dq, dim=1).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_16_byte_aligned(name: str, t: torch.Tensor) -> None:
    """The bf16 kernel copies rows in 16-byte pieces (``cp.async``): the
    base and every stride it steps by must be multiples of 16 bytes."""
    if t.data_ptr() % 16:
        raise ValueError(f"bf16 flash kernel needs {name} at a 16-byte "
                         f"aligned address, got {t.data_ptr():#x}")
    for d in range(3):
        if t.shape[d] > 1 and t.stride(d) * t.element_size() % 16:
            raise ValueError(f"bf16 flash kernel needs {name}'s strides in "
                             f"multiples of 16 bytes, got {t.stride()} "
                             f"elements of {t.element_size()} bytes")


def _launch(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
    """The kernel on CUDA tensors the wrapper has checked."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    dev, stream = _build.stream_args(q)
    _build.FLASH_ATTENTION.launch(
        _ENTRIES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, kh, hd, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(causal),
        0 if window is None else window, dev, stream)
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the plain-torch gradient behind it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, dout, causal=ctx.causal,
                                          window=ctx.window), None, None)


def flash_attention_cost(q, k, v, *, causal: bool = True,
                         window: int | None = None):
    """(flops, bytes) of a call: 4 hd flops for each (query, key) pair the
    mask keeps, in each (batch, head); q, k, v read once and the output
    written once, in their dtype."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    pos = np.arange(sq) + (sk - sq)               # each query's position
    hi = pos if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    return (4.0 * b * h * hd * pairs,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd) with KH | H -> (B, Sq, H, hd)
    in q's dtype. Causal masking is aligned by ``Sk - Sq``; ``window`` keeps
    the previous ``window`` keys (the query's own included). Causal calls
    with Sq > Sk are refused: their first Sq - Sk rows would see no key,
    where the reference gives NaN and the TPU kernel a mean of v. On the
    card, with grad mode on and an input that requires grad, the output
    carries the gradient of q, k and v. DTensors run on their shards; a
    ``meta`` call returns an empty output after charging its cost."""
    if isinstance(q, DTensor):
        return heads_on_shards(
            lambda a, b, c: _flash_attention(a, b, c, causal=causal,
                                             window=window), q, k, v)
    return _flash_attention(q, k, v, causal=causal, window=window)


@charged("flash_attention", flash_attention_cost)
def _flash_attention(q, k, v, *, causal: bool = True,
                     window: int | None = None) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, sk, kh, hd) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"{kh} kv heads do not divide {h} query heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got Sq {sq} > "
                         f"Sk {sk}: the first rows would see no key")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k, v must be contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_16_byte_aligned(name, t)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)
