"""Channel tiling, paper §3.2, for the image-style wire backends.

Counterpart of ``repro/core/tiling.py``: C channels (a power of two) are
laid out as a ``rows x cols`` grid of H x W tiles, channel k at tile
``(k // cols, k % cols)``. Works on torch tensors on any device.
"""
from __future__ import annotations

import math

import torch


def tile_grid(c: int) -> tuple[int, int]:
    """(rows, cols) of the tiling for C channels (C must be a power of 2)."""
    if c < 1 or (c & (c - 1)) != 0:
        raise ValueError(f"C must be a power of two, got {c}")
    lg = int(math.log2(c))
    return 1 << (lg // 2), 1 << ((lg + 1) // 2)


def tile_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, rows*H, cols*W)."""
    b, h, w, c = x.shape
    rows, cols = tile_grid(c)
    y = x.permute(0, 3, 1, 2).reshape(b, rows, cols, h, w)
    return y.permute(0, 1, 3, 2, 4).reshape(b, rows * h, cols * w)


def untile_batch(img: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`tile_batch`: (B, rows*H, cols*W) -> (B, H, W, C)."""
    rows, cols = tile_grid(c)
    b, th, tw = img.shape
    h, w = th // rows, tw // cols
    y = img.reshape(b, rows, h, cols, w).permute(0, 1, 3, 2, 4)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)
