"""End-to-end LM training: train a ~20M-parameter qwen2-family model
on the synthetic token stream, with a checkpoint and a simulated preemption
and resume in the middle.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200] \
        [--fast] [--device cpu] [--ckpt-dir DIR]

Counterpart of ``examples/train_lm.py`` (default device: the card): the
single-host face of ``launch/train.py``, with the same TrainState,
checkpoint protocol and data determinism. Without ``--ckpt-dir`` the
checkpoint goes to a temporary directory that is removed at the end. Exits
1 unless the loss decreases.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import TokenDatasetConfig, token_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import (TrainConfig, init_params,
                                       init_train_state, make_train_step)


def run(steps: int, ckpt_dir: str, dev) -> tuple[float, float]:
    """-> (first loss, last loss)."""
    # ~25M params: the qwen2 smoke family scaled up
    cfg = get_smoke_config("qwen2_7b").with_(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=704, vocab=32_000)
    params = init_params(cfg, seed=0, device=dev)
    n = sum(p.numel() for p in params.values())
    print(f"model: {cfg.name}-family, {n / 1e6:.1f}M params, on {dev}")

    tcfg = TrainConfig(num_microbatches=2, peak_lr=1e-3,
                       warmup_steps=max(steps // 10, 5), total_steps=steps)
    state = init_train_state(params, tcfg)
    step_fn = make_train_step(cfg, tcfg)
    data = TokenDatasetConfig(vocab_size=cfg.vocab, seq_len=128, batch_size=8)

    half = steps // 2
    it = token_batch_iterator(data, seed=0, device=dev)
    t0 = time.time()
    first = None
    for s in range(half):
        state, m = step_fn(state, next(it))
        first = first if first is not None else float(m["loss"])
        if s % 20 == 0:
            print(f"step {s:4d}  loss {float(m['loss']):.4f}  "
                  f"({(time.time()-t0)/(s+1):.2f}s/step)", flush=True)

    print(f"== simulated preemption at step {half}: checkpoint + discard "
          f"state ==")
    ckpt.save(ckpt_dir, half, state)
    del state

    like = init_train_state(init_params(cfg, seed=0, device=dev), tcfg)
    state, at = ckpt.restore(ckpt_dir, like=like)
    print(f"== resumed from step {at} ==")
    it = token_batch_iterator(data, seed=0, start_step=at, device=dev)
    for s in range(at, steps):
        state, m = step_fn(state, next(it))
        if s % 20 == 0 or s == steps - 1:
            print(f"step {s:4d}  loss {float(m['loss']):.4f}", flush=True)
    final = float(m["loss"])
    print(f"loss {first:.3f} -> {final:.3f} over {steps} steps "
          f"({time.time()-t0:.0f}s total); checkpoint protocol exercised "
          f"(atomic save, newest-complete restore, deterministic data "
          f"replay)")
    return first, final


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    steps = 40 if args.fast else args.steps
    dev = resolve_device(args.device)
    if args.ckpt_dir:
        first, final = run(steps, args.ckpt_dir, dev)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            first, final = run(steps, tmp, dev)
    if not final < first:
        print(f"FAIL: the loss did not decrease ({first} -> {final})")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
