"""Program cost counter: flops, bytes and collective bytes of one eager run.

Counterpart of ``repro/launch/hlo_cost.py::analyze_compiled``. PyTorch has
no compiled HLO to parse, so :func:`analyze_program` runs the program once
under a ``TorchDispatchMode`` and counts every ATen operation it
dispatches:

  flops             ``torch.utils.flop_counter``'s formulas: 2·M·N·K for a
                    matmul, the real multiply-adds of a convolution (a
                    transposed one over its input, not over inserted
                    zeros)
  bytes             each materializing op reads its tensor inputs once and
                    writes its outputs once; views and metadata ops are
                    free. Eager PyTorch runs every op as a kernel, so
                    elementwise ops count (the TPU model counts them free:
                    XLA fuses them)
  collective_bytes  the result bytes of each c10d collective, by kind

Eager code is unrolled, so no trip count scales anything. The reference's
text parser ``analyze_hlo_text`` has no counterpart: nothing in the port
produces XLA text.

DTensor programs (the cells of ``launch.specs``) count per device: an op
on DTensors is passed on to DTensor's dispatch, which runs the local op on
this process's shards under the counter, and the global-shape shadow ops
that DTensor's sharding propagation runs on fake tensors are not counted.
``FlopCounterMode`` would count the DTensor op's global flops instead.

The hand-written kernels are ctypes calls that no dispatch mode sees. Each
kernel wrapper is decorated with :func:`charged`: while a counter is
active it records one entry (the kernel's name, its flops and its bytes,
inputs read once and outputs written once, from the shapes) and suspends
the counting of ATen ops inside the wrapper. So a program counts the same
on the CPU, where the wrappers run their plain versions, as on the card.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_program_counter", default=None)

# ops that move no bytes: allocations, aliases and size queries that
# dispatch without being views in their schema
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
         "alias", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_local_scalar_dense",
         "resize_", "set_"}
# in-place ops that overwrite their first argument without reading it
_WRITE_ONLY = {"copy_", "zero_", "fill_", "normal_", "uniform_",
               "random_", "bernoulli_"}
_COLLECTIVE_KINDS = (("reduce_scatter", "reduce-scatter"),
                     ("allreduce", "all-reduce"),
                     ("all_reduce", "all-reduce"),
                     ("allgather", "all-gather"),
                     ("all_gather", "all-gather"),
                     ("alltoall", "all-to-all"),
                     ("all_to_all", "all-to-all"),
                     ("broadcast", "broadcast"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _tensors(x):
    """The tensors in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(*xs) -> int:
    """Bytes of every tensor in ``xs``: numel times element size."""
    return sum(t.numel() * t.element_size() for x in xs for t in _tensors(x))


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func.overloadpacket.__name__
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


class ProgramCounter(TorchDispatchMode):
    """The counts of the ops dispatched while it is active (use
    :func:`analyze_program`)."""

    def __init__(self, *, track_peak: bool = False):
        super().__init__()
        self.track_peak = track_peak
        self.live = 0
        self.peak = 0
        self.flops = 0.0
        self.bytes_by_op: dict[str, float] = {}
        self.collective_bytes: dict[str, float] = {}
        self.kernels: list[dict] = []
        self.suspended = 0

    def _add_bytes(self, op: str, n: float) -> None:
        if n:
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + n

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """One hand-written kernel call."""
        self.kernels.append({"name": name, "flops": float(flops),
                             "bytes": float(nbytes)})
        self.flops += float(flops)
        self._add_bytes(name, float(nbytes))

    @contextlib.contextmanager
    def suspend(self):
        """Count nothing dispatched inside (a kernel wrapper's body)."""
        self.suspended += 1
        try:
            yield
        finally:
            self.suspended -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops it runs
        out = func(*args, **kwargs)
        if self.suspended or any(isinstance(t, FakeTensor) for t in
                                 _tensors([args, kwargs, out])):
            return out
        packet = func.overloadpacket
        name = packet.__name__
        kind = _collective_kind(func)
        if kind is not None:
            res = out[0] if isinstance(out, (list, tuple)) else out
            self.collective_bytes[kind] = \
                self.collective_bytes.get(kind, 0.0) + _nbytes(res)
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if func.is_view or name in _FREE:
            return out
        if self.track_peak:
            self._track(out)
        read = list(args) + list(kwargs.values())
        if name in _WRITE_ONLY and read:
            read = read[1:]
        self._add_bytes(name, _nbytes(read) + _nbytes(out))
        return out

    def _track(self, out) -> None:
        """Count each new output's bytes live until its tensor is freed."""
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            if not n:
                continue
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def result(self) -> dict:
        by = dict(self.bytes_by_op)
        res = {"flops": self.flops, "bytes": sum(by.values()),
               "bytes_by_op": by,
               "collective_bytes": dict(self.collective_bytes),
               "kernels": list(self.kernels)}
        if self.track_peak:
            res["peak_bytes"] = self.peak
        return res


def analyze_program(fn, *args, track_peak: bool = False, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its counts:
    ``{'flops', 'bytes', 'bytes_by_op', 'collective_bytes', 'kernels'}``
    (``kernels``: one entry per hand-written kernel call, in order), and
    with ``track_peak`` ``'peak_bytes'``: the most bytes of op outputs
    alive at once (an output counts from its op until its tensor is
    freed; kernel outputs are not seen). Per-process quantities: what
    this process dispatched."""
    counter = ProgramCounter(track_peak=track_peak)
    token = _ACTIVE.set(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.reset(token)
    return counter.result()


def charged(name: str, cost):
    """Decorate a kernel wrapper: while a counter is active, charge one
    entry ``(name, *cost(*args, **kwargs))`` (flops, bytes) after the
    wrapper returns, with the ops it dispatches not counted. Without a
    counter the wrapper runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            counter = _ACTIVE.get()
            if counter is None or counter.suspended:
                return fn(*args, **kwargs)
            with counter.suspend():
                out = fn(*args, **kwargs)
            counter.charge(name, *cost(*args, **kwargs))
            return out
        return wrapper
    return wrap
