"""Checkpoints and restart, in the JAX package's on-disk layout.

Counterpart of ``repro/train/checkpoint.py``. Layout:
``<dir>/step_<N>/arrays.npz`` (leaves ``a0``, ``a1``, ...) and
``manifest.msgpack`` with the keys ``step``, ``names``, ``dtypes`` and
``shapes``. A tree is nested dicts (flattened in sorted-key order, as
``jax.tree`` flattens them), lists, tuples and named tuples, with tensors
or numpy arrays as leaves and ``None`` as an empty node; leaf names are
JAX's key strings (``['up']['w']``, ``[0]``, ``.mu``). So a checkpoint that
``repro.train.checkpoint.save`` wrote of a params dict restores here.

Writes are atomic: the step is written into a temp dir beside it and
renamed into place, so a preemption mid-write never corrupts the newest
complete checkpoint, which is the one ``restore`` picks.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Optional

import msgpack
import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = ""):
    """-> [(name, leaf)] in ``jax.tree`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f, v in zip(tree._fields, tree)
                for item in _flatten(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with the leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically save a tree as checkpoint ``step`` -> its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    leaves = [_to_numpy(x) for _, x in flat]
    manifest = {
        "step": step,
        "names": [n for n, _ in flat],
        "dtypes": [str(a.dtype) for a in leaves],
        "shapes": [list(a.shape) for a in leaves],
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(leaves)})
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(msgpack.packb(manifest))
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir`` (``None``: none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.msgpack")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None):
    """Restore into the structure of ``like`` -> (tree, step), or (None,
    None) when there is nothing to restore. Each leaf takes the type of
    ``like``'s: a tensor of its dtype on its device (requiring grad where
    ``like``'s does, as the trainer's master weights), or a numpy array of
    its dtype."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    flat_like = _flatten(like)
    names = manifest["names"]
    if len(flat_like) != len(names):
        raise ValueError(f"checkpoint has {len(names)} leaves, expected "
                         f"{len(flat_like)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(names))]
    out = []
    for (name, ref), saved, arr in zip(flat_like, names, arrays):
        if name != saved or tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {saved} {arr.shape} does not "
                             f"fit {name} {tuple(ref.shape)}")
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(arr).to(ref.device, ref.dtype)
            out.append(t.requires_grad_(True) if ref.requires_grad else t)
        else:
            out.append(arr.astype(np.asarray(ref).dtype))
    return _unflatten(like, iter(out)), step


def retain_last(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for m in
                   (_STEP_RE.match(d) for d in os.listdir(ckpt_dir)) if m)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
