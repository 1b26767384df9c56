"""Chunked linear-attention scan (RWKV-6 / Mamba-2): wrapper and plain version.

``linear_scan`` is the counterpart of ``repro/kernels/ops.py::linear_scan``
around ``linear_scan_pallas``: a CUDA tensor goes through the kernel in
``csrc/linear_scan.cu`` (or the call raises); a CPU tensor goes through
``linear_scan_plain``, the chunked algorithm of
``repro/models/linear_attention.py::chunked_linear_attention`` in float32,
with its decay factorisation ``exp(la) * exp(-la)`` kept as it is (a long
chunk overflows exactly where the reference's does). Both clamp the
log-decay to [LOG_DECAY_MIN, -1e-9], broadcast a (..., 1) decay over dk
and a (H, dk) bonus over the batch, and read the heads in place from
(B, S, H, d).

Gradients: with grad mode on and any input requiring grad, a CUDA call goes
through ``_LinearScan``, a ``torch.autograd.Function`` whose forward is the
same launch and whose backward is :func:`linear_scan_backward`: the vjp of
``linear_scan_plain``, recomputed in plain torch from the saved inputs, for
q, k, v, the log-decay (summed back to a (B, S, H, 1) decay's shape), the
bonus and the initial state, with the cotangents of both outputs. The JAX
package has no backward kernel (XLA differentiates its reference path), so
there is none here.

DTensor inputs are redistributed so that the scan is local (batch and
heads sharded; sequence, key, value and state dims replicated) and each
rank runs the wrapper on its shards. A ``meta`` call charges its cost and
returns empty meta outputs, for the dry run.
"""
from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.api import on_shards
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged

LOG_DECAY_MIN = -4.0   # clamp: e^{|min|*chunk} must stay inside fp32
LOG_DECAY_MAX = -1e-9
MODES = ("rwkv", "ssm")
_ENTRIES = {torch.float32: "linear_scan_f32",
            torch.bfloat16: "linear_scan_bf16"}
_SMEM_BYTES = 227 * 1024


_MAX_DK = 128          # the state rows a thread of the carry pass holds
_JS = 16               # dv columns per block of the carry pass
_PB = 64               # rows of a chunk the carry pass copies at once


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _r8(n: int) -> int:
    return (n + 7) // 8 * 8


def _smem_floats(chunk: int, dk: int, dv: int, per_channel: bool) -> int:
    """Shared memory of the larger of the kernel's two passes, as
    ``smem_bytes_a`` and ``smem_bytes_b`` in the CUDA source. Pass A at
    chunks up to 64 (``smem_floats_a``): rows over dk padded to a multiple
    of 4, plus 4 (q, k, k_rem and the log-decay, a scalar one broadcast
    over dk); rows over dv to a multiple of 64; an [L][L] score buffer.
    Pass A at longer chunks, on the tensor cores (``smem_floats_mma``):
    the chunk padded to 16 rows, rows over dk and dv padded to a multiple
    of 8, plus 4; q, k and a third area holding the per-channel
    log-decay, then v; three chunk-long vectors, 256 for la_end and 4
    flags. Pass B (``smem_floats_b``): two stages of at most 64 rows of a
    chunk and the state's slice."""
    dk4, dv64 = _r4(dk), (dv + 63) // 64 * 64
    if chunk > 64:
        lp = (chunk + 15) // 16 * 16
        sk, sv = _r8(dk) + 4, _r8(dv) + 4
        third = lp * sk if per_channel and sk > sv else lp * sv
        a = 2 * lp * sk + third + _r4(3 * lp) + 256 + 4
    else:
        a = 4 * chunk * (dk4 + 4) + chunk * dv64 \
            + _r4(chunk * chunk + chunk + dk)
    rows = min(chunk, _PB)      # pass B copies a chunk in such pieces
    stage = rows * dk4 + rows * (dk4 + 4) + 2 * rows * _JS + dk4
    return max(a, 2 * stage + dk4 * _JS)


def _scratch_floats(b: int, h: int, nc: int, chunk: int, dk: int,
                    dv: int) -> int:
    """Floats of the pass-A-to-pass-B scratch, ``scratch_chunk_floats`` in
    the CUDA source for each of the B * H * (S / chunk) chunks."""
    dk4, dv64 = _r4(dk), (dv + 63) // 64 * 64
    return b * h * nc * (2 * chunk * dk4 + 2 * chunk * dv64 + dk4)


def linear_scan_plain(q, k, v, log_decay, *, bonus=None, initial_state=None,
                      chunk: int = 16, mode: str = "rwkv"):
    """q, k (B, S, H, dk); v (B, S, H, dv); log_decay (B, S, H, dk) or
    (B, S, H, 1); bonus (H, dk) or None; initial_state (B, H, dk, dv) or
    None -> (y (B, S, H, dv), final state (B, H, dk, dv)), float32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    ld = torch.clamp(log_decay.to(f32), LOG_DECAY_MIN, LOG_DECAY_MAX)

    def chunks(t):      # (B, S, H, d) -> (NC, B, H, L, d)
        return t.reshape(b, s // chunk, chunk, h, t.shape[-1]) \
            .permute(1, 0, 3, 2, 4)

    qc, kc, vc, ldc = chunks(q), chunks(k), chunks(v), chunks(ld)
    la = torch.cumsum(ldc, dim=-2)                  # inclusive
    la_prev = la - ldc                              # exclusive
    la_end = la[..., -1:, :]
    la_q = la_prev if mode == "rwkv" else la
    qd = qc * torch.exp(la_q)
    kd = kc * torch.exp(-la)
    k_rem = kc * torch.exp(la_end - la)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=q.device),
                     diagonal=-1 if mode == "rwkv" else 0)
    scores = torch.einsum("cbhtd,cbhsd->cbhts", qd, kd) * tri
    y_intra = torch.einsum("cbhts,cbhsv->cbhtv", scores, vc)
    if mode == "rwkv" and bonus is not None:
        bq = torch.einsum("cbhtd,hd,cbhtd->cbht", qc, bonus.to(f32), kc)
        y_intra = y_intra + bq[..., None] * vc
    state = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
             if initial_state is None else initial_state.to(f32))
    y_inter = []
    for c in range(qc.shape[0]):
        y_inter.append(torch.einsum("bhtd,bhdv->bhtv", qd[c], state))
        state = torch.exp(la_end[c][..., 0, :])[..., None] * state \
            + torch.einsum("bhtd,bhtv->bhdv", k_rem[c], vc[c])
    y = y_intra + torch.stack(y_inter)
    return y.permute(1, 0, 3, 2, 4).reshape(b, s, h, dv), state


def linear_scan_backward(inputs, dy, dstate, *, chunk: int, mode: str):
    """The gradient of :func:`linear_scan_plain` at ``inputs`` = (q, k, v,
    log_decay, bonus, initial_state) (bonus and initial_state may be None)
    for the cotangents ``dy`` and ``dstate`` of its two outputs (either may
    be None): the plain version's vjp, recomputed. One gradient per input,
    each in its input's dtype and shape; None for an absent input."""
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in inputs]
    wrt = [t for t in leaves if t is not None]
    with torch.enable_grad():
        y, state = linear_scan_plain(*leaves[:4], bonus=leaves[4],
                                     initial_state=leaves[5], chunk=chunk,
                                     mode=mode)
        outs = [o for o, g in ((y, dy), (state, dstate)) if g is not None]
        grads = torch.autograd.grad(
            outs, wrt, [g for g in (dy, dstate) if g is not None],
            allow_unused=True)
    it = iter(grads)
    out = []
    for t in leaves:
        g = None if t is None else next(it)
        out.append(None if t is None else
                   torch.zeros_like(t) if g is None else g.to(t.dtype))
    return tuple(out)


def _launch(q, k, v, log_decay, bonus, initial_state, chunk: int,
            mode: str):
    """The kernel's two passes on CUDA tensors the wrapper has checked."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    dev_t = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ld = log_decay.to(torch.float32).contiguous()
    u = None if bonus is None else bonus.to(torch.float32).contiguous()
    s0 = None if initial_state is None else \
        initial_state.to(torch.float32).contiguous()
    y = torch.empty((b, s, h, dv), dtype=torch.float32, device=dev_t)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev_t)
    # scratch: each chunk's k_rem, qd, v, y_intra and decays, from the
    # chunk pass to the carry pass
    scratch = torch.empty(_scratch_floats(b, h, s // chunk, chunk, dk, dv),
                          dtype=torch.float32, device=dev_t)
    dev, stream = _build.stream_args(q)
    _build.LINEAR_SCAN.launch(
        _ENTRIES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ld.data_ptr(), None if u is None else u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), state.data_ptr(),
        scratch.data_ptr(), b, s, h, dk, dv, chunk,
        int(mode == "rwkv"), int(log_decay.shape[3] == dk), dev, stream)
    return y, state


class _LinearScan(torch.autograd.Function):
    """The kernel's forward with the plain version's vjp behind it."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state, chunk, mode):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        ctx.chunk, ctx.mode = chunk, mode
        return _launch(q, k, v, log_decay, bonus, initial_state, chunk, mode)

    @staticmethod
    def backward(ctx, dy, dstate):
        return (*linear_scan_backward(ctx.saved_tensors, dy, dstate,
                                      chunk=ctx.chunk, mode=ctx.mode),
                None, None)


def linear_scan_cost(q, k, v, log_decay, *, bonus=None, initial_state=None,
                     chunk: int = 16, mode: str = "rwkv"):
    """(flops, bytes) of a call. Flops: each chunk's products over the
    (t, s) pairs the mask keeps (s < t in rwkv mode, s <= t in ssm), the
    state carried in and out, and the elementwise decay and bonus terms.
    Bytes: q, k, v read once in their dtype, the decay, bonus and initial
    state once in float32, y and the final state written once in
    float32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pairs = chunk * (chunk - 1) // 2 if mode == "rwkv" else \
        chunk * (chunk + 1) // 2
    per_chunk = (2 * pairs * dk + 2 * pairs * dv + 4 * chunk * dk * dv
                 + 8 * chunk * dk)
    nbytes = ((q.numel() + k.numel()) * q.element_size()
              + v.numel() * v.element_size() + log_decay.numel() * 4
              + b * s * h * dv * 4 + b * h * dk * dv * 4
              + (0 if bonus is None else bonus.numel() * 4)
              + (0 if initial_state is None else initial_state.numel() * 4))
    return float(b * h * (s // chunk) * per_chunk), nbytes


def _scan_on_shards(q, k, v, log_decay, bonus, initial_state, chunk, mode):
    """The wrapper on each rank's shards of DTensor inputs."""
    mesh = q.device_mesh
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    # (H, dk) bonus: the heads; (B, H, dk, dv) state: the batch and heads
    bp = tuple(Shard(0) if p == Shard(2) else Replicate() for p in qp)
    sp = tuple(Shard(1) if p == Shard(2) else p for p in qp)

    def placed(t):      # a plain input (a bonus, a state) is replicated
        return t if t is None or isinstance(t, DTensor) else \
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)

    def local(q, k, v, ld, bonus, state):
        return _linear_scan(q, k, v, ld, bonus=bonus, initial_state=state,
                            chunk=chunk, mode=mode)
    inputs = tuple(placed(t) for t in (q, k, v, log_decay, bonus,
                                       initial_state))
    return on_shards(local, inputs, (qp, qp, qp, qp, bp, sp), (qp, sp),
                     ((b, s, h, dv), (b, h, dk, dv)))


def linear_scan(q, k, v, log_decay, *, bonus=None, initial_state=None,
                chunk: int = 16, mode: str = "rwkv"):
    """Same contract as :func:`linear_scan_plain`; S must be a multiple of
    ``chunk``. On the card q, k, v are float32 or bf16 of one dtype, and
    with grad mode on and an input that requires grad, y and the final
    state carry the gradients of every input. DTensors run on their
    shards; a ``meta`` call returns empty outputs after charging its
    cost."""
    if isinstance(q, DTensor):
        return _scan_on_shards(q, k, v, log_decay, bonus, initial_state,
                               chunk, mode)
    return _linear_scan(q, k, v, log_decay, bonus=bonus,
                        initial_state=initial_state, chunk=chunk, mode=mode)


@charged("linear_scan", linear_scan_cost)
def _linear_scan(q, k, v, log_decay, *, bonus=None, initial_state=None,
                 chunk: int = 16, mode: str = "rwkv"):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q, k must be (B, S, H, dk) and v (B, S, H, dv); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if log_decay.shape[:3] != q.shape[:3] or log_decay.shape[3] not in (1, dk):
        raise ValueError(f"log_decay {tuple(log_decay.shape)} must be "
                         f"(B, S, H, dk) or (B, S, H, 1)")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if bonus is not None and tuple(bonus.shape) != (h, dk):
        raise ValueError(f"bonus must be (H, dk), got {tuple(bonus.shape)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (b, h, dk, dv):
        raise ValueError(f"initial_state must be (B, H, dk, dv), got "
                         f"{tuple(initial_state.shape)}")
    if q.device.type == "cpu":
        return linear_scan_plain(q, k, v, log_decay, bonus=bonus,
                                 initial_state=initial_state, chunk=chunk,
                                 mode=mode)
    if q.device.type == "meta":
        return (torch.empty((b, s, h, dv), dtype=torch.float32,
                            device="meta"),
                torch.empty((b, h, dk, dv), dtype=torch.float32,
                            device="meta"))
    if q.device.type != "cuda":
        raise ValueError(f"no linear-scan kernel for device {q.device}")
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"linear-scan kernel takes float32 or bfloat16 q, "
                         f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    per_channel = log_decay.shape[3] == dk
    if _smem_floats(chunk, dk, dv, per_channel) * 4 > _SMEM_BYTES \
            or dk > _MAX_DK:
        raise ValueError(f"chunk {chunk}, dk {dk}, dv {dv} with "
                         f"{'a per-channel' if per_channel else 'a scalar'} "
                         f"decay do not fit the kernel: a block's shared "
                         f"memory and dk <= {_MAX_DK}")
    inputs = (q, k, v, log_decay, bonus, initial_state)
    for t in inputs[1:]:
        if t is not None and t.device != q.device:
            raise ValueError("all inputs must be on one device")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return _LinearScan.apply(*inputs, chunk, mode)
    return _launch(*inputs, chunk, mode)
