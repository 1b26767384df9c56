"""Weights, frames and request schedules, all from ``--seed``.

The weights and the frames are drawn on the run's device by one
``torch.Generator`` in a few large calls, in float32 (the precision they
are served in). The same weights are loaded into the port's modules and
handed, as the benchmark's own tensors, to the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, draw, scale) of every weight of the CNN and the BaF net.

    draw ``n``: scale * N(0, 1); ``u``: uniform in [scale, 3 * scale)
    (BN scale and variance in [0.5, 1.5), PReLU slopes in [0.1, 0.3)).
    """
    specs = []

    def conv_bn(prefix, cin, cout, k):
        specs.append((f"{prefix}.conv.weight", (cout, cin, k, k), "n",
                      math.sqrt(2.0 / (cin * k * k))))
        specs.append((f"{prefix}.bn.scale", (cout,), "u", 0.5))
        specs.append((f"{prefix}.bn.bias", (cout,), "n", 0.1))
        specs.append((f"{prefix}.bn.mean", (cout,), "n", 0.1))
        specs.append((f"{prefix}.bn.var", (cout,), "u", 0.5))

    for i, (cin, cout, k, _) in enumerate(cfg["stem"]):
        conv_bn(f"cnn.stem.{i}", cin, cout, k)
    cin, cout, k, _ = cfg["split"]
    conv_bn("cnn.split", cin, cout, k)
    for j in range(cfg["tail_res_blocks"]):
        for i, (cin, cout, k) in enumerate(cfg["tail"]):
            conv_bn(f"cnn.tail.{2 * j + i}", cin, cout, k)
    p, classes = cfg["split_shape"][2], cfg["num_classes"]
    specs.append(("cnn.head.weight", (p, classes), "n", math.sqrt(1.0 / p)))
    specs.append(("cnn.head.bias", (classes,), "n", 0.1))
    c, hid, q = cfg["c"], cfg["baf_hidden"], cfg["split_q"]
    for name, cin, cout in (("up", c, hid), ("c2", hid, hid),
                            ("c3", hid, hid), ("c4", hid, q)):
        specs.append((f"baf.{name}.weight", (cout, cin, 3, 3), "n",
                      math.sqrt(2.0 / (cin * 9))))
        specs.append((f"baf.{name}.bias", (cout,), "n", 0.05))
        if name != "c4":
            specs.append((f"baf.{name}_act.alpha", (cout,), "u", 0.1))
    return specs


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & SEED_MASK)


def make_weights(cfg: dict, gen: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Every weight, from one normal and one uniform draw on ``device``."""
    specs = weight_specs(cfg)
    sizes = {d: sum(math.prod(s) for _, s, dd, _ in specs if dd == d)
             for d in ("n", "u")}
    flat = {"n": torch.randn(sizes["n"], generator=gen, device=device),
            "u": torch.rand(sizes["u"], generator=gen, device=device)}
    out, off = {}, {"n": 0, "u": 0}
    for key, shape, d, scale in specs:
        n = math.prod(shape)
        t = flat[d][off[d]:off[d] + n].view(shape)
        off[d] += n
        out[key] = t * scale if d == "n" else scale * (1.0 + 2.0 * t)
    return out


def make_frames(cfg: dict, n: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """(n, S, S, 3) float32 frames, uniform in [0, 1), in one call."""
    s = cfg["input_size"]
    return torch.rand((n, s, s, 3), generator=gen, device=device)


def make_selection(cfg: dict, seed: int) -> np.ndarray:
    """C distinct channels of the P split channels, in a seeded order."""
    rng = np.random.default_rng([seed & SEED_MASK, 1])
    return rng.permutation(cfg["split_shape"][2])[:cfg["c"]].astype(np.int64)


class Schedule:
    """Which pool frame each request carries, and which requests the
    correctness check keeps in full (``sample_share`` of them), drawn from
    the seed for up to ``MAX`` requests a run."""

    MAX = 1 << 21

    def __init__(self, seed: int, pool: int, sample_share: float = 1.0):
        rng = np.random.default_rng([seed & SEED_MASK, 2])
        self.frame = rng.integers(0, pool, self.MAX, dtype=np.int32)
        self.keep = rng.random(self.MAX) < sample_share
