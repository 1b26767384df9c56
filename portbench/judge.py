"""Whether what the timed path produced is correct, by the plain reference.

The reference (``portbench/reference``) works every frame of the pool out
again from the benchmark's own frames and weights: the edge, eq. 4 and
its fp16 side info, the container, its unpacking, the restore and the
cloud. The program's answers are read only to be judged:

* ``logit_gap`` (cloud and gateway cells): over every answered request,
  the largest ``|logit - reference logit|`` over the request's largest
  ``|reference logit|``.
* ``code_bin_excess`` (edge cell): over the sampled requests' wire bytes,
  parsed by the reference, how far (in bins of the container's own fp16
  side info) the reference's split tensor lies outside the bin of the
  code sent for it, at the worst code; a container the reference cannot
  read counts as infinite.

``control=True`` computes the reference in TF32, the control that each
limit must fail.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.reference import wire

BLOCK = 8


def _blocks(frames_host: np.ndarray, device):
    for i in range(0, frames_host.shape[0], BLOCK):
        yield torch.from_numpy(frames_host[i:i + BLOCK]).to(device)


def split_tensors(cfg, w, sel, frames_host, device, *, tf32=False):
    """(pool, H, W, C) of the selected split channels of every frame."""
    idx = torch.as_tensor(sel, device=device)
    return torch.cat([ref.edge(w, cfg, img, tf32=tf32)[..., idx]
                      for img in _blocks(frames_host, device)])


def blobs(cfg, w, sel, frames_host, device, *, tf32=False) -> list[bytes]:
    """The container of every frame, one frame a request, as a client of
    the reference would send it."""
    out = []
    z = split_tensors(cfg, w, sel, frames_host, device, tf32=tf32)
    for i in range(z.shape[0]):
        zi = z[i:i + 1]
        mins, maxs = ref.side_info(zi)
        codes = ref.quantize(zi, mins, maxs, cfg["bits"])
        out.append(wire.write(codes.cpu().numpy(), mins, maxs, cfg["bits"]))
    return out


def logits(cfg, w, sel, frames_host, device, *, tf32=False) -> np.ndarray:
    """(pool, classes): each frame through the whole reference pipeline."""
    shape = (1, *cfg["split_shape"][:2], cfg["c"])
    idx = torch.as_tensor(sel, device=device)
    rows = []
    data = blobs(cfg, w, sel, frames_host, device, tf32=tf32)
    for i in range(0, len(data), BLOCK):
        parts = [wire.read(b, shape, cfg["bits"]) for b in data[i:i + BLOCK]]
        codes = torch.from_numpy(np.concatenate([p[0] for p in parts]))
        mins = np.concatenate([p[1] for p in parts])
        maxs = np.concatenate([p[2] for p in parts])
        z = ref.restore(w, cfg, idx, codes.to(device), mins, maxs, tf32=tf32)
        rows.append(ref.cloud(w, cfg, z, tf32=tf32).cpu().numpy())
    return np.concatenate(rows)


def logit_gap(frames: list, answers: list, ref_logits: np.ndarray) -> float:
    if not answers:
        return math.inf
    got = np.stack([np.asarray(a, np.float64) for a in answers])
    want = ref_logits[np.asarray(frames)].astype(np.float64)
    gap = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    return float(np.nan_to_num(gap, nan=math.inf).max())


def bin_excess(z_sel: torch.Tensor, codes: torch.Tensor, mins, maxs,
               bits: int) -> float:
    """Largest distance, in bins, of z_sel (1, H, W, C) outside the bins of
    ``codes`` under the fp16 side info (mins, maxs) (1, C)."""
    levels = float((1 << bits) - 1)
    dev = z_sel.device
    m = torch.from_numpy(mins.astype(np.float32)).to(dev)[:, None, None, :]
    mx = torch.from_numpy(maxs.astype(np.float32)).to(dev)[:, None, None, :]
    s = torch.clamp((z_sel - m) / torch.clamp(mx - m, min=1e-12) * levels,
                    0, levels)
    excess = torch.clamp((s - codes.to(dev).float()).abs() - 0.5, min=0)
    return float(torch.nan_to_num(excess, nan=math.inf).max())


def code_bin_excess(cfg, frames: list, answers: list,
                    z_sel: torch.Tensor) -> float:
    if not answers:
        return math.inf
    shape = (1, *cfg["split_shape"][:2], cfg["c"])
    worst = 0.0
    for f, data in zip(frames, answers):
        try:
            codes, mins, maxs = wire.read(data, shape, cfg["bits"])
        except (wire.WireError, ValueError):
            return math.inf
        worst = max(worst, bin_excess(z_sel[f:f + 1], torch.from_numpy(codes),
                                      mins, maxs, cfg["bits"]))
    return worst


def numbers(kind: str, cfg, w, sel, frames_host, device, frames, answers,
            want, *, control: bool = False) -> dict:
    """{name: reading} of one run's answers against ``want``, the float32
    reference's result (:func:`reference_for`). ``control``: the answers
    are replaced by the TF32 reference's own (the control run)."""
    if kind == "edge_closed_loop":
        if control:
            data = blobs(cfg, w, sel, frames_host, device, tf32=True)
            frames, answers = list(range(len(data))), data
        return {"code_bin_excess": code_bin_excess(cfg, frames, answers,
                                                   want)}
    if control:
        got = logits(cfg, w, sel, frames_host, device, tf32=True)
        frames, answers = list(range(len(got))), list(got)
    return {"logit_gap": logit_gap(frames, answers, want)}


def reference_for(kind, cfg, w, sel, frames_host, device):
    """The float32 reference's result that :func:`numbers` compares with:
    the split tensors (edge) or every frame's logits."""
    if kind == "edge_closed_loop":
        return split_tensors(cfg, w, sel, frames_host, device)
    return logits(cfg, w, sel, frames_host, device)
