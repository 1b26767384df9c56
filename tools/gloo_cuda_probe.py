#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors, with two ranks on one card.

    python3 tools/gloo_cuda_probe.py

Needs one CUDA device. NCCL refuses two ranks on one device, so the port
tests its multi-rank paths on one card with gloo ranks sharing it. This
script starts two gloo ranks on ``cuda:0`` (rendezvous through a file, a
60 s timeout) and tries ``all_reduce`` (SUM and MAX), ``all_gather``,
``broadcast``, and the three that DTensor's redistributions issue
(``all_gather_into_tensor``, ``reduce_scatter_tensor`` SUM and
``all_to_all_single``) of a CUDA tensor of each dtype; rank 0 prints one line a
(collective, dtype): ``ok`` with the result checked, or the error. Both
ranks make the same call, so a refusal is raised on both. ``send`` and
``recv`` are not tried: gloo's send hands the tensor's pointer to its
transport as host memory, which a device pointer is not.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = ("float32", "float16", "bfloat16", "int32", "int16", "int8",
          "uint8")


def _try(fn):
    try:
        return fn()
    except RuntimeError as e:           # a refused dtype or device
        return f"refused: {str(e).splitlines()[0][:120]}"


def _rank(rank: int, init_file: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    rows = []
    try:
        for name in DTYPES:
            dtype = getattr(torch, name)
            mine = torch.full((8,), rank + 1, device=dev).to(dtype)

            def reduce(op, want):
                t = mine.clone()
                dist.all_reduce(t, op=op)
                return "ok" if bool((t == want).all()) else f"wrong: {t}"

            def gather():
                out = [torch.empty_like(mine) for _ in range(2)]
                dist.all_gather(out, mine)
                ok = all(bool((o == i + 1).all()) for i, o in enumerate(out))
                return "ok" if ok else f"wrong: {out}"

            def broadcast():
                t = mine.clone()
                dist.broadcast(t, src=1)
                return "ok" if bool((t == 2).all()) else f"wrong: {t}"

            def gather_into():
                out = torch.empty((16,), dtype=dtype, device=dev)
                dist.all_gather_into_tensor(out, mine)
                ok = bool((out[:8] == 1).all()) and bool((out[8:] == 2).all())
                return "ok" if ok else f"wrong: {out}"

            def reduce_scatter():
                src = torch.cat([mine, mine * 2])        # 16 entries
                out = torch.empty((8,), dtype=dtype, device=dev)
                dist.reduce_scatter_tensor(out, src)
                # rank r gets the sum of both ranks' r-th halves
                want = 3 * (rank + 1)
                return "ok" if bool((out == want).all()) else f"wrong: {out}"

            def all_to_all():
                src = torch.cat([mine, mine + 10])        # halves for 0, 1
                out = torch.empty_like(src)
                dist.all_to_all_single(out, src)
                ok = bool((out[:8] == 1 + 10 * rank).all()) and \
                    bool((out[8:] == 2 + 10 * rank).all())
                return "ok" if ok else f"wrong: {out}"
            rows += [(f"all_gather_into_tensor {name}", _try(gather_into)),
                     (f"reduce_scatter_tensor SUM {name}",
                      _try(reduce_scatter)),
                     (f"all_to_all_single {name}", _try(all_to_all)),
                     (f"all_reduce SUM {name}",
                      _try(lambda: reduce(dist.ReduceOp.SUM, 3))),
                     (f"all_reduce MAX {name}",
                      _try(lambda: reduce(dist.ReduceOp.MAX, 2))),
                     (f"all_gather {name}", _try(gather)),
                     (f"broadcast {name}", _try(broadcast))]
        if rank == 0:
            for what, res in rows:
                print(f"gloo on {torch.cuda.get_device_name(0)}, cuda "
                      f"tensors: {what}: {res}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "rendezvous"),), nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
