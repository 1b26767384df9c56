"""Seeded draws that every family shares: the generator, weights from a
list of specs, the copy of those weights into the port's modules, and the
schedule of which pool entry each request carries.

Weights are drawn on the run's device by one ``torch.Generator`` in a few
large calls, in float32 (the precision they are served in). The same
weights are loaded into the port's modules and handed, as the benchmark's
own tensors, to the reference. What a family draws, and in which order,
is its ``make_inputs``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & SEED_MASK)


def make_weights(specs: list[tuple[str, tuple, str, float]],
                 gen: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Every weight of ``specs`` ((key, shape, draw, scale), in order), from
    one normal and one uniform draw on ``device``.

    draw ``n``: scale * N(0, 1); ``u``: uniform in [scale, 3 * scale).
    """
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


def load(module: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Copy ``weights[prefix + key]`` into every tensor of the module's
    state dict; the two key sets must be the same."""
    state = module.state_dict()
    mine = {k[len(prefix):] for k in weights if k.startswith(prefix)}
    if mine != set(state):
        raise KeyError(f"{prefix}: weights {sorted(mine ^ set(state))} do "
                       f"not match the port's module")
    with torch.no_grad():
        for key, t in state.items():
            src = weights[prefix + key]
            if src.shape != t.shape:
                raise ValueError(f"{prefix}{key}: {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src)


class Schedule:
    """Which pool entry each request carries, and which requests the
    correctness check keeps in full (``sample_share`` of them), drawn from
    the seed for up to ``MAX`` requests a run."""

    MAX = 1 << 21

    def __init__(self, seed: int, pool: int, sample_share: float = 1.0):
        rng = np.random.default_rng([seed & SEED_MASK, 2])
        self.frame = rng.integers(0, pool, self.MAX, dtype=np.int32)
        self.keep = rng.random(self.MAX) < sample_share
