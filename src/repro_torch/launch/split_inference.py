"""Tier-A end to end: the paper's experiment at reduced scale.

    PYTHONPATH=src python -m repro_torch.launch.split_inference [--fast] \
        [--device cpu]

Counterpart of ``examples/split_inference.py`` (default device: the card):

1. pretrain the YOLO-front CNN on the synthetic detection-proxy task,
2. offline channel selection from the split layer's statistics (eqs. 2-3),
3. train BaF predictors for a sweep of C with the original network frozen
   (Charbonnier loss, eq. 7, quantization in the loop),
4. run split inference through the wire codec and report accuracy and
   bits per image against the cloud-only baseline (Figs. 3-4).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs.yolo_baf import smoke_config, smoke_data_config
from repro_torch.core.split import SplitInferenceEngine
from repro_torch.data.synthetic import shapes_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.train.baf_trainer import (compute_channel_order, eval_cnn,
                                           pretrain_cnn, train_baf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cnn_cfg = smoke_config()._replace(input_size=64)
    data_cfg = smoke_data_config()._replace(image_size=64, batch_size=16)
    p = cnn_cfg.split_p

    print(f"== 1. pretrain CNN (split layer: {p} channels) on {dev} ==")
    t0 = time.time()
    model, _ = pretrain_cnn(cnn_cfg, data_cfg,
                            steps=150 if args.fast else 800, verbose=True,
                            device=dev)
    cloud_acc = eval_cnn(model, data_cfg, batches=20, device=dev)
    print(f"cloud-only accuracy: {cloud_acc:.3f}  ({time.time() - t0:.0f}s)")

    print("== 2. offline channel selection (eqs. 2-3) ==")
    order = compute_channel_order(model, data_cfg,
                                  batches=4 if args.fast else 12,
                                  device=dev).order
    print(f"channel order (best-first): {order[:10]}...")

    print("== 3-4. BaF sweep over C (n=8), real wire ==")
    print(f"{'C':>4} {'acc':>7} {'Δacc':>7} {'bits/img':>10} {'vs raw':>8}")
    for c in (4, 8, 16, 32, 64):
        if c > p:
            break
        res = train_baf(model, cnn_cfg, data_cfg, order[:c], bits=8,
                        hidden=16, steps=100 if args.fast else 400,
                        verbose=False, device=dev)
        eng = SplitInferenceEngine(model, res.baf_params, res.sel_idx,
                                   bits=8, device=dev)
        it = shapes_batch_iterator(data_cfg, seed=10_000, device=dev)
        accs, bits = [], []
        for _ in range(4 if args.fast else 15):
            img, labels = next(it)
            logits, stats = eng(img)
            accs.append(float((logits.argmax(dim=-1) == labels).float()
                              .mean()))
            bits.append(stats.total_bits / img.shape[0])
        acc = float(np.mean(accs))
        print(f"{c:>4} {acc:>7.3f} {cloud_acc - acc:>+7.3f} "
              f"{np.mean(bits):>10.0f} "
              f"{1 - np.mean(bits) / stats.raw_bits * img.shape[0]:>8.1%}")
    print("(paper: C=P/4 with <1% accuracy loss at ~62% bit reduction)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
