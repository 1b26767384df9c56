"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the control's.

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, the check's numbers (``program``); and the same numbers
with the reference computed in TF32 put in the program's place
(``control``: the family's reference in TF32, products' operands rounded
to TF32 and summed in float32). One JSON line per seed on standard
output. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{"program": {number: reading, ...}, "control": {number: reading}}
    for one seed."""
    from portbench import bench, trace
    st = bench.Setup(cell, seed, device)
    st.window(0.0, trace.spans(False))
    win = st.window(seconds, trace.spans(False))
    st.release()
    fam, args = cell.family, (cell.kind, cell.cfg, st.inputs, device)
    want = fam.reference(*args)
    nums = fam.numbers(*args, win.frames, win.answers, want)
    return {"program": dict(nums, answers=len(win.answers),
                            verdict=bench.verdict(cell, win, nums)),
            "control": fam.numbers(*args, [], [], want, control=True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import bench
    if not torch.cuda.is_available():
        print("control.py runs on a card", file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
