"""Training loss of the BaF predictor, paper eq. (7).

Counterpart of ``repro/core/losses.py``.
"""
from __future__ import annotations

import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3,
                mean: bool = True) -> torch.Tensor:
    """Charbonnier penalty ``sqrt((pred - target)^2 + eps^2)``, eq. (7), in
    float32: the mean over all elements (``mean=False``: the paper's sum)."""
    d = pred.float() - target.float()
    v = torch.sqrt(d.square() + eps * eps)
    return v.mean() if mean else v.sum()
