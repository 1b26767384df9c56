"""Channel selection, paper §3.1, eqs. (2)-(3).

Counterpart of ``repro/core/selection.py``. Offline: from samples of the
split layer's input X (Q channels, at twice Z's resolution behind the
stride-2 split conv) and of its BN output Z (P channels), rank Z's
channels by their mean |Pearson rho| with all of X's, and keep the top C.

An eq. (3) score does not change as other channels are removed, so the
paper's iterative re-selection is one stable descending sort of the
per-channel totals (``select_channels``); ``select_channels_greedy`` is the
literal procedure, kept for the property test of that equivalence.

The correlations run on the tensors' device in float32; the ranking runs
on the host in numpy, so the same rho gives the same order everywhere.
Conv tensors are (B, H, W, C); transformer streams (B, S, D) take the
stride-1 case (``correlation_matrix_stream``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class SelectionResult(NamedTuple):
    order: np.ndarray      # (P,) channel indices of Z, best-first
    scores: np.ndarray     # (P,) eq. (3) totals, in the order of `order`
    rho: np.ndarray        # (P, Q) mean absolute correlation matrix


def _flatten_leading(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> (B * prod(spatial), C)."""
    return x.reshape(-1, x.shape[-1])


def stride2_offsets(x: torch.Tensor) -> list[torch.Tensor]:
    """The four stride-2 downsampled versions of an NHWC tensor (s=0..3)."""
    return [x[:, i::2, j::2, :] for i in range(2) for j in range(2)]


def _abs_corr(z_flat: torch.Tensor, x_flat: torch.Tensor) -> torch.Tensor:
    """|Pearson rho| of every column of z_flat (P) with every column of
    x_flat (Q) -> (P, Q), float32."""
    z = z_flat.float()
    x = x_flat.float()
    z = z - z.mean(dim=0, keepdim=True)
    x = x - x.mean(dim=0, keepdim=True)
    zn = torch.linalg.vector_norm(z, dim=0)
    xn = torch.linalg.vector_norm(x, dim=0)
    dots = z.T @ x
    denom = torch.clamp(zn[:, None] * xn[None, :], min=1e-12)
    return (dots / denom).abs()


def correlation_matrix_conv(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Eq. (2) for a stride-2 conv split: mean |rho| over the 4 offsets.

    z: (B, H, W, P) BN output; x: (B, 2H, 2W, Q) layer input -> (P, Q).
    """
    zf = _flatten_leading(z)
    rhos = [_abs_corr(zf, _flatten_leading(xs)) for xs in stride2_offsets(x)]
    return sum(rhos) / 4.0


def correlation_matrix_stream(z: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Eq. (2), stride-1 case, for (B, S, D) streams -> (P, Q)."""
    return _abs_corr(_flatten_leading(z), _flatten_leading(x))


def _host(rho) -> np.ndarray:
    if isinstance(rho, torch.Tensor):
        return rho.detach().cpu().numpy()
    return np.asarray(rho)


def select_channels(rho) -> SelectionResult:
    """Eq. (3): Z's channels by total correlation with all of X's, best
    first (a stable sort: equal totals keep index order)."""
    rho = _host(rho)
    totals = rho.sum(axis=1)
    order = np.argsort(-totals, kind="stable")
    return SelectionResult(order=order, scores=totals[order], rho=rho)


def select_channels_greedy(rho, c: int) -> np.ndarray:
    """The paper's literal procedure: take the best remaining channel, C
    times (ties to the lower index)."""
    rho = _host(rho)
    totals = rho.sum(axis=1).copy()
    chosen: list[int] = []
    remaining = set(range(rho.shape[0]))
    for _ in range(c):
        p_star = max(remaining, key=lambda p: (totals[p], -p))
        chosen.append(p_star)
        remaining.remove(p_star)
    return np.asarray(chosen)


def accumulate_correlation(batches_zx: Sequence[tuple], conv: bool = True
                           ) -> SelectionResult:
    """Eq. (2) over a dataset: the mean of the per-batch rho matrices, then
    eq. (3). (z, x) pairs as ``correlation_matrix_conv`` takes them, or as
    ``correlation_matrix_stream`` with ``conv=False``."""
    fn = correlation_matrix_conv if conv else correlation_matrix_stream
    acc = None
    n = 0
    for z, x in batches_zx:
        r = fn(z, x)
        acc = r if acc is None else acc + r
        n += 1
    if acc is None:
        raise ValueError("no batches supplied")
    return select_channels(acc / n)
