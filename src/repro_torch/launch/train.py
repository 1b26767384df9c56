"""Training launcher: auto-resume, atomic checkpoints, preemption handling
and the watchdog's straggler escape, at an arch's smoke config.

Counterpart of ``repro/launch/train.py``, with the same arguments and
``--device`` (default: the card; ``cpu`` runs the plain versions):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
      --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --steps 50 --ckpt-dir ck --ckpt-every 20   # kill -TERM mid-run,
                                                 # rerun: resumes

One process on one device. The multi-pod step with the compressed
gradient exchange (``make_train_step(..., mesh=, multi_pod=True)``, one
process per pod) is driven by ``chip_smoke.py`` and the tests; the
reference's multi-host mesh launch waits for ROADMAP Queue 1 step 10d.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import canonical, get_smoke_config
from repro_torch.data.synthetic import TokenDatasetConfig, token_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (PreemptionFlag, StepDeadlineExceeded,
                                     Watchdog)
from repro_torch.train.trainer import (TrainConfig, init_params,
                                       init_train_state, make_train_step)


def build(arch: str, *, seq_len: int, batch: int, microbatches: int,
          steps: int, lr: float, device=None):
    cfg = get_smoke_config(arch)
    if cfg.family == "audio":
        raise SystemExit("use --arch of an LM family for the token stream")
    tcfg = TrainConfig(num_microbatches=microbatches, peak_lr=lr,
                       warmup_steps=max(steps // 20, 5), total_steps=steps)
    state = init_train_state(init_params(cfg, seed=0, device=device), tcfg)
    step_fn = make_train_step(cfg, tcfg)
    data = TokenDatasetConfig(vocab_size=cfg.vocab, seq_len=seq_len,
                              batch_size=batch)
    return cfg, tcfg, state, step_fn, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog", action="store_true",
                    help="per-step deadline straggler escape")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, tcfg, state, step_fn, data = build(
        canonical(args.arch), seq_len=args.seq_len, batch=args.batch,
        microbatches=args.microbatches, steps=args.steps, lr=args.lr,
        device=dev)

    start = 0
    if args.ckpt_dir:
        restored, at = ckpt.restore(args.ckpt_dir, like=state)
        if restored is not None:
            state, start = restored, at
            print(f"[resume] restored step {at} from {args.ckpt_dir}")

    flag = PreemptionFlag().install()
    wd = Watchdog() if args.watchdog else None
    it = token_batch_iterator(data, seed=args.seed, start_step=start,
                              device=dev)
    t0 = time.time()
    for s in range(start, args.steps):
        batch = next(it)
        try:
            if wd is not None:
                state, metrics = wd.guard(step_fn, state, batch)
            else:
                state, metrics = step_fn(state, batch)
        except StepDeadlineExceeded as e:
            print(f"[watchdog] {e}; checkpointing and exiting for reschedule")
            if args.ckpt_dir:
                ckpt.save(args.ckpt_dir, s, state)
            return 75                      # EX_TEMPFAIL-style requeue code
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"step {s:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics.get('grad_norm', 0)):.2f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(time.time()-t0)/max(s-start+1,1):.2f}s/step", flush=True)
        if args.ckpt_dir and ((s + 1) % args.ckpt_every == 0 or flag.triggered
                              or s == args.steps - 1):
            path = ckpt.save(args.ckpt_dir, s + 1, state)
            ckpt.retain_last(args.ckpt_dir, keep=args.keep)
            if flag.triggered:
                print(f"[preempt] SIGTERM received; saved {path}; exiting 0")
                return 0
    print(f"done: {args.steps} steps in {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
