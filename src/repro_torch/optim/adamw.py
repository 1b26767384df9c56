"""AdamW on a name -> tensor dict of a module's trainable parameters.

Counterpart of ``repro/optim/adamw.py``, with its arithmetic: the gradients
are clipped to a global norm first; the moments are float32; the step is
``m / b1c / (sqrt(v / b2c) + eps)``; weight decay is added to the step of
the leaves the decay mask selects (by default those with ndim >= 2). Its
defaults (b2 0.95, weight decay 0.1, clip at 1.0) are not those of
``torch.optim.AdamW``. ``adamw_update`` returns new tensors and a new
state, like the reference; a trainer copies them into its parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # (name, leaf) -> whether the leaf is decayed; None: ndim >= 2
    decay_mask: Optional[Callable[[str, torch.Tensor], bool]] = None


class AdamWState(NamedTuple):
    count: torch.Tensor        # 0-dim int32, steps taken
    mu: dict
    nu: dict


def adamw_init(params: dict) -> AdamWState:
    """Zero float32 moments beside each parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(count=torch.zeros((), dtype=torch.int32),
                      mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares."""
    sums = [x.detach().float().square().sum() for x in tree.values()]
    return torch.sqrt(sum(sums))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))`` as a 0-dim tensor."""
    # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """Scale every leaf by :func:`clip_scale` of the global norm ->
    (clipped, norm)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


def _default_decay_mask(name: str, leaf: torch.Tensor) -> bool:
    """Decay matrices and kernels; skip vectors (BN, biases, PReLU)."""
    return leaf.ndim >= 2


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step -> (new params, new state, metrics).

    ``grads`` and ``params`` are dicts with the same keys; ``lr`` a float
    or a 0-dim tensor (a schedule's value). The bias corrections are 0-dim
    tensors on each leaf's device, so that a division on the card is an
    IEEE divide (a Python scalar divisor becomes a product by its
    reciprocal there).
    """
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    count = state.count + 1
    t = count.to(torch.float32)
    corr = torch.stack([1.0 - torch.tensor(b, dtype=torch.float32) ** t
                        for b in (cfg.b1, cfg.b2)])
    on_device = {}                      # device -> (b1c, b2c), one copy each
    mask_fn = cfg.decay_mask or _default_decay_mask
    new_params, mu, nu = {}, {}, {}
    for k, p in params.items():
        if p.device not in on_device:
            on_device[p.device] = corr.to(p.device).unbind()
        b1c, b2c = on_device[p.device]
        g = grads[k].float()
        mu[k] = cfg.b1 * state.mu[k] + (1 - cfg.b1) * g
        nu[k] = cfg.b2 * state.nu[k] + (1 - cfg.b2) * g.square()
        step = mu[k] / b1c / (torch.sqrt(nu[k] / b2c) + cfg.eps)
        if cfg.weight_decay and mask_fn(k, p):
            step = step + cfg.weight_decay * p.float()
        new_params[k] = (p.float() - lr * step).to(p.dtype)
    return new_params, AdamWState(count=count, mu=mu, nu=nu), metrics
