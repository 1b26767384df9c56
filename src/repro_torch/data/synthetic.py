"""Deterministic synthetic data: shape images, token streams, camera clips.

Counterpart of ``repro/data/synthetic.py``.

  * shapes: the Tier-A detection-proxy task. Each image holds one ring of
    k+3 Gaussian blobs (class k) in a random colour, plus sensor noise.
  * tokens: LM token streams with a per-sequence topic band and copy spans.

Each batch is a pure function of (seed, step): it is drawn from a
``torch.Generator`` on the target device, seeded from the pair, so a job
restarted at ``start_step`` sees the same stream. The numbers are not
``jax.random``'s (nor the same on the CPU and on the card): parity tests
feed the renderer the reference's own draws, as :class:`ShapesDraws`.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose state is a function of (seed, step)."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    mixed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(mixed)


# ---------------------------------------------------------------------------
# Images: shape classification proxy
# ---------------------------------------------------------------------------

class ShapesDatasetConfig(NamedTuple):
    image_size: int = 64
    num_classes: int = 8
    batch_size: int = 16
    noise: float = 0.15


class ShapesDraws(NamedTuple):
    """The random draws of one batch; ``render_shapes`` turns them into
    images."""
    labels: torch.Tensor       # (B,) int64 class k: a ring of k+3 blobs
    centres: torch.Tensor      # (B, 2) float32 ring centre (x, y), pixels
    radii: torch.Tensor        # (B,) float32 ring radius, pixels
    colours: torch.Tensor      # (B, 3) float32
    noise: torch.Tensor        # (B, S, S, 3) float32 standard normal


def draw_shapes(cfg: ShapesDatasetConfig,
                gen: torch.Generator) -> ShapesDraws:
    """Labels, centres in [0.3, 0.7) S, radii in [0.15, 0.3) S, colours in
    [0.4, 1.0) and unit noise, on ``gen``'s device."""
    b, s = cfg.batch_size, cfg.image_size
    kw = dict(generator=gen, device=gen.device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **kw)

    labels = torch.randint(0, cfg.num_classes, (b,), **kw)
    centres = uniform((b, 2), 0.3, 0.7) * s
    radii = uniform((b,), 0.15, 0.3) * s
    colours = uniform((b, 3), 0.4, 1.0)
    noise = torch.randn((b, s, s, 3), **kw)
    return ShapesDraws(labels, centres, radii, colours, noise)


def render_shapes(d: ShapesDraws, cfg: ShapesDatasetConfig) -> torch.Tensor:
    """(B, S, S, 3) float32 images: per image the max over its blobs of
    exp(-d^2 / (2 (0.06 S)^2)) times its colour, plus ``noise`` times the
    unit noise. In float32 with the reference's operation order; its
    divisions are tensor divisions (a Python scalar divisor is a product
    by a reciprocal on the card)."""
    s = cfg.image_size
    dev = d.centres.device
    f32 = dict(dtype=torch.float32, device=dev)
    grid = torch.arange(s, **f32)
    yy, xx = grid[:, None], grid[None, :]
    n_blobs = torch.clamp(d.labels + 3, min=1).to(torch.float32)
    ang = torch.arange(12, **f32) * (
        torch.full_like(n_blobs, 2 * math.pi) / n_blobs)[:, None]   # (B, 12)
    active = torch.arange(12, device=dev) < (d.labels + 3)[:, None]
    bx = d.centres[:, :1] + d.radii[:, None] * torch.cos(ang)
    by = d.centres[:, 1:] + d.radii[:, None] * torch.sin(ang)
    d2 = (xx - bx[..., None, None]) ** 2 + (yy - by[..., None, None]) ** 2
    blob = torch.exp(-d2 / torch.tensor(2 * (0.06 * s) ** 2, **f32)) \
        * active[..., None, None]
    img = blob.amax(dim=1)                                           # (B, S, S)
    imgs = img[..., None] * d.colours[:, None, None, :]
    return (imgs + cfg.noise * d.noise).to(torch.float32)


def shapes_batch(cfg: ShapesDatasetConfig, seed: int, step: int,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch ``step`` of stream ``seed`` -> (images (B, S, S, 3), labels
    (B,) int64) on ``device`` (``None`` = the card)."""
    d = draw_shapes(cfg, _generator(seed, step, resolve_device(device)))
    return render_shapes(d, cfg), d.labels


def shapes_batch_iterator(cfg: ShapesDatasetConfig, seed: int = 0,
                          start_step: int = 0, *,
                          device=None) -> Iterator[tuple]:
    dev = resolve_device(device)
    step = start_step
    while True:
        yield shapes_batch(cfg, seed, step, dev)
        step += 1


# ---------------------------------------------------------------------------
# Tokens: LM stream
# ---------------------------------------------------------------------------

class TokenDatasetConfig(NamedTuple):
    vocab_size: int = 32000
    seq_len: int = 512
    batch_size: int = 8
    copy_span: int = 32       # copy structure: x[t] = x[t - copy_span]
    copy_prob: float = 0.5


def token_batch(cfg: TokenDatasetConfig, gen: torch.Generator) -> dict:
    """{"tokens", "labels"}: (B, seq_len) int32 each, labels the tokens
    shifted by one. Each sequence draws from a band of 256 ids (its topic);
    with probability ``copy_prob`` a position from ``copy_span`` on copies
    the token ``copy_span`` before it."""
    kw = dict(generator=gen, device=gen.device)
    b, n = cfg.batch_size, cfg.seq_len + 1
    topics = torch.randint(0, max(cfg.vocab_size // 256, 1), (b, 1), **kw)
    base = topics * 256 + torch.randint(0, min(256, cfg.vocab_size), (b, n),
                                        **kw)
    base = torch.clamp(base, max=cfg.vocab_size - 1)
    rolled = torch.roll(base, cfg.copy_span, dims=1)
    mask = torch.rand((b, n), **kw) < cfg.copy_prob
    pos_ok = torch.arange(n, device=gen.device)[None, :] >= cfg.copy_span
    seq = torch.where(mask & pos_ok, rolled, base)
    return {"tokens": seq[:, :-1].to(torch.int32),
            "labels": seq[:, 1:].to(torch.int32)}


def token_batch_iterator(cfg: TokenDatasetConfig, seed: int = 0,
                         start_step: int = 0, *,
                         device=None) -> Iterator[dict]:
    dev = resolve_device(device)
    step = start_step
    while True:
        yield token_batch(cfg, _generator(seed, step, dev))
        step += 1


# ---------------------------------------------------------------------------
# Video: temporally correlated camera frames
# ---------------------------------------------------------------------------

def correlated_frames(n_frames: int, *, image_size: int = 32,
                      num_classes: int = 8, drift: float = 0.03,
                      noise: float = 0.02, seed: int = 0) -> np.ndarray:
    """A synthetic camera clip, (N, S, S, 3) float32 on the host: one
    noiseless shapes scene rolled by a random walk of scale ``drift * S``
    pixels a frame, plus fresh noise of scale ``noise`` in each frame. A
    pure function of the seed."""
    if n_frames < 1:
        raise ValueError("need at least one frame")
    rng = np.random.default_rng(seed)
    cfg = ShapesDatasetConfig(image_size=image_size, num_classes=num_classes,
                              batch_size=1, noise=0.0)
    cpu = torch.device("cpu")
    base = render_shapes(draw_shapes(cfg, _generator(seed, 0, cpu)), cfg)
    base = base[0].numpy()                                   # (S, S, 3)
    frames = np.empty((n_frames, image_size, image_size, 3), np.float32)
    off = np.zeros(2)
    for i in range(n_frames):
        off += rng.normal(scale=drift * image_size, size=2)
        shift = np.round(off).astype(int)
        img = np.roll(base, shift, axis=(0, 1))
        img = img + rng.normal(scale=noise, size=img.shape)
        frames[i] = img.astype(np.float32)
    return frames


# ---------------------------------------------------------------------------
# Multi-host sharding
# ---------------------------------------------------------------------------

def host_shard_slice(batch, host_index: int, host_count: int):
    """This host's rows of a global batch (a tensor, array, or a dict,
    list or tuple of them): the ``host_index``-th of ``host_count`` equal
    slices of the leading dim."""
    if isinstance(batch, dict):
        return {k: host_shard_slice(v, host_index, host_count)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [host_shard_slice(v, host_index, host_count) for v in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") else \
            type(batch)(out)
    per = batch.shape[0] // host_count
    return batch[host_index * per:(host_index + 1) * per]
