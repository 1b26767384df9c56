"""The paper's scheme on a multi-pod pipeline boundary.

Port of ``examples/pod_boundary_compression.py``, one process per pod:

  PYTHONPATH=src python -m repro_torch.launch.pod_boundary
      # the card, world size 1 over NCCL (the ring sends to itself)
  PYTHONPATH=src python -m repro_torch.launch.pod_boundary --device cpu \\
      --world 2
      # 2 gloo ranks on the CPU, a pod each

Every pod holds the same seeded hidden stream x (B, S, D). It crosses to
the next pod (a) whole, n-bit codes (eq. 4) through the quantize kernel,
at n = 8 and 4, and (b) as C of D channels restored there by the stream
BaF predictor and a frozen block, consolidated (eq. 6) through the
consolidate kernel. Rank 0 prints the wire bytes against bf16, the
largest dequantization error and the subset's bytes. A rank that fails
ends the run non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.baf import BaFStream, BaFStreamConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import init_mesh
from repro_torch.distributed.pipeline import (compressed_pod_transfer,
                                              subset_pod_transfer, wire_bytes)

B, S, D, C = 4, 64, 256, 64


def run(mesh, device: torch.device) -> list[str]:
    """Both transfers on this pod -> the example's lines."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, D), generator=gen).to(device)
    lines = []
    for bits in (8, 4):
        y = compressed_pod_transfer(x, mesh, bits=bits, dtype=torch.float32)
        comp, raw = wire_bytes(x, bits)
        err = float((y - x).abs().max())     # every pod holds the same x
        lines.append(f"[full  n={bits}] wire {comp:>8,} B vs bf16 {raw:>8,}"
                     f" B ({raw / comp:.1f}x less)  max dequant err "
                     f"{err:.4f}")
    baf = BaFStream(BaFStreamConfig(c=C, d_in=D, hidden=128), seed=1,
                    device=device)
    w_block = (torch.randn((D, D), generator=gen) * 0.05).to(device)
    y = subset_pod_transfer(x, mesh, sel_idx=torch.arange(C), baf=baf,
                            forward_fn=lambda t: t @ w_block, bits=8,
                            dtype=torch.float32)
    if tuple(y.shape) != tuple(x.shape) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"the subset transfer restored {tuple(y.shape)}, "
                           f"finite: {bool(torch.isfinite(y).all())}")
    comp, _ = wire_bytes(x[..., :C], 8)
    lines.append(f"[subset C={C}/{D} n=8] wire {comp:>8,} B vs bf16 full "
                 f"{x.numel() * 2:>8,} B ({x.numel() * 2 / comp:.1f}x less);"
                 f" restored {tuple(y.shape)} (predictor untrained here)")
    lines.append("wire-byte accounting matches the paper's: payload + "
                 "C*32-bit side info")
    return lines


def _rank(rank: int, world: int, init_file: str) -> None:
    """One gloo pod on the CPU."""
    torch.set_num_threads(1)
    mesh = init_mesh((world, 1, 1), backend="gloo", rank=rank, world=world,
                     init_file=init_file, device_type="cpu")
    try:
        lines = run(mesh, torch.device("cpu"))
        if rank == 0:
            print("\n".join(lines), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the CPU (default: the card, "
                         "world size 1 over NCCL)")
    ap.add_argument("--world", type=int, default=1,
                    help="pods, one process each (the card takes 1)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        if dev.type == "cpu":
            mp.spawn(_rank, args=(args.world, init_file), nprocs=args.world)
            return 0
        if args.world != 1:
            raise SystemExit("the card runs one pod: NCCL takes one rank "
                             "a device")
        mesh = init_mesh((1, 1, 1), backend="nccl", rank=0, world=1,
                         init_file=init_file, device_type="cuda")
        try:
            print("\n".join(run(mesh, dev)), flush=True)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
