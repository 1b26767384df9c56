"""Task-head registry: N downstream consumers of one restored BaF tensor.

Counterpart of ``repro/tasks/heads.py``. The source paper compresses the
split activation for exactly one consumer (the detector's cloud half). The
multi-task line of work (Alvar & Bajić 2020, arXiv 2002.07048; "Multi-task
learning with compressible features", arXiv 1902.05179) shares that single
encoded stream across several task heads — here:

  * ``classify``: the repo's own cloud tail (``CNN.cloud``) — Leaky sigma,
    darknet res blocks, GAP, dense class head. It reuses the gateway's CNN;
    the head bank carries no extra weights for it.
  * ``detect``: a dense per-cell prediction head — the restored tensor's
    spatial grid is flattened to tokens, projected to a small d_model,
    passed through one bidirectional LayerNorm-attention + GELU-FFN block
    (models/attention.py + models/ffn.py), then projected to a YOLO-shaped
    (box_fields + num_classes) vector per cell. Its attention goes through
    the flash wrapper: on the card the flash kernel, one launch per call
    (float32, head dim 16, not causal, one token per cell).
  * ``embed``: a lightweight retrieval embedding — Leaky sigma, global
    average pool, dense projection, L2 normalization.

Every head consumes the *restored* tensor ``z_tilde`` that
:meth:`repro_torch.pipeline.CompressionPlan.restore` produces — one decode +
restore pass feeds all of them. The heads run on the device ``z`` lives on
(their weights must live there too); the divergences are float64 numpy on
the host, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.ffn import FFN, ffn_apply


class HeadConfig(NamedTuple):
    """Static geometry every head's init/forward closes over.

    split_p     : channels of the restored split tensor (CNNConfig.split_p)
    num_classes : classification/detection class count
    d_model     : token width of the detect head's encoder block
    n_heads     : attention heads of the detect head
    d_ff        : FFN width of the detect head
    box_fields  : per-cell box regression slots of the detect head
    embed_dim   : output width of the embedding head
    """
    split_p: int
    num_classes: int = 8
    d_model: int = 32
    n_heads: int = 2
    d_ff: int = 64
    box_fields: int = 5
    embed_dim: int = 32

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


@dataclass(frozen=True)
class TaskHead:
    """One registered downstream task.

    init(gen, cfg)                    -> head module (its weights drawn
                                         from the CPU ``torch.Generator``
                                         ``gen``; the classify head has none)
    forward(cnn, head_params, z, cfg) -> task output for the batch, on z's
                                         device
    divergence(ref, out)              -> scalar output divergence of this
                                         head's outputs vs the
                                         uncompressed-tensor reference
                                         (0 = identical; lower is better)
    """
    name: str
    init: Callable
    forward: Callable
    divergence: Callable


_REGISTRY: dict[str, TaskHead] = {}


def register_head(head: TaskHead) -> TaskHead:
    if head.name in _REGISTRY:
        raise ValueError(f"task head {head.name!r} already registered")
    _REGISTRY[head.name] = head
    return head


def get_head(name: str) -> TaskHead:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown task head {name!r} "
                       f"(registered: {available_heads()})") from None


def available_heads() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# classify — the repo's own cloud tail
# ---------------------------------------------------------------------------

def _classify_init(gen, cfg: HeadConfig) -> nn.Module:
    return nn.Module()           # reuses the gateway's CNN cloud half


def _classify_forward(cnn, head_params, z, cfg: HeadConfig):
    return cnn.cloud(z)


def _softmax_kl(ref: np.ndarray, out: np.ndarray) -> float:
    """Mean KL(ref || out) of softmaxed logits — the same divergence
    core.split.fidelity_metrics reports for the downstream classifier."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    ref = ref - ref.max(axis=-1, keepdims=True)
    out = out - out.max(axis=-1, keepdims=True)
    p = np.exp(ref) / np.exp(ref).sum(axis=-1, keepdims=True)
    q = np.exp(out) / np.exp(out).sum(axis=-1, keepdims=True)
    eps = 1e-12
    return float(np.mean(np.sum(p * (np.log(p + eps) - np.log(q + eps)),
                                axis=-1)))


# ---------------------------------------------------------------------------
# detect — encoder-block dense per-cell head
# ---------------------------------------------------------------------------

class DetectHead(nn.Module):
    """The detect head's weights, named as the JAX param tree names them."""

    def __init__(self, cfg: HeadConfig, *, gen=None):
        super().__init__()
        self.proj = tnn.Dense(cfg.split_p, cfg.d_model, gen=gen)
        self.ln1 = tnn.LayerNorm(cfg.d_model)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_heads,
                              cfg.head_dim, qkv_bias=True, gen=gen)
        self.ln2 = tnn.LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, "gelu", gen=gen)
        self.out = tnn.Dense(cfg.d_model, cfg.box_fields + cfg.num_classes,
                             gen=gen)


def _detect_forward(cnn, head_params: DetectHead, z, cfg: HeadConfig):
    b, h, w, p = z.shape
    x = head_params.proj(tnn.leaky_relu(z).reshape(b, h * w, p))
    x = x + attention_apply(
        head_params.attn, head_params.ln1(x), n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_heads, head_dim=cfg.head_dim, rope_theta=10000.0,
        causal=False, impl="flash")
    x = x + ffn_apply(head_params.ffn, head_params.ln2(x))
    y = head_params.out(x)
    return y.reshape(b, h, w, cfg.box_fields + cfg.num_classes)


def _normalized_mse(ref: np.ndarray, out: np.ndarray) -> float:
    """MSE of the dense map normalized by reference power (scale-free)."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    denom = float(np.mean(ref * ref)) + 1e-12
    return float(np.mean((ref - out) ** 2)) / denom


# ---------------------------------------------------------------------------
# embed — lightweight retrieval embedding
# ---------------------------------------------------------------------------

class EmbedHead(nn.Module):
    def __init__(self, cfg: HeadConfig, *, gen=None):
        super().__init__()
        self.proj = tnn.Dense(cfg.split_p, cfg.embed_dim, gen=gen)


def _embed_forward(cnn, head_params: EmbedHead, z, cfg: HeadConfig):
    feat = tnn.leaky_relu(z).mean(dim=(1, 2))                  # GAP
    e = head_params.proj(feat)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)


def _cosine_distance(ref: np.ndarray, out: np.ndarray) -> float:
    """Mean (1 - cosine) over embedding rows (rows are ~unit-norm)."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    num = np.sum(ref * out, axis=-1)
    den = (np.linalg.norm(ref, axis=-1) * np.linalg.norm(out, axis=-1)
           + 1e-12)
    return float(np.mean(1.0 - num / den))


register_head(TaskHead(name="classify", init=_classify_init,
                       forward=_classify_forward, divergence=_softmax_kl))
register_head(TaskHead(name="detect",
                       init=lambda gen, cfg: DetectHead(cfg, gen=gen),
                       forward=_detect_forward, divergence=_normalized_mse))
register_head(TaskHead(name="embed",
                       init=lambda gen, cfg: EmbedHead(cfg, gen=gen),
                       forward=_embed_forward, divergence=_cosine_distance))


# ---------------------------------------------------------------------------
# Banks and forwards
# ---------------------------------------------------------------------------

def init_head_bank(gen: torch.Generator, cfg: HeadConfig, *, heads=None,
                   device=None) -> dict:
    """{name: head module} for ``heads`` (default: every registered head),
    drawn in sorted name order from the CPU generator ``gen`` (the same
    numbers on every device) and moved to ``device`` (``None`` = the card).
    The JAX package's ``jax.random`` draws cannot be reproduced: parity
    checks bridge its bank (``bridge.heads_from_jax``)."""
    dev = resolve_device(device)
    names = tuple(sorted(heads)) if heads is not None else available_heads()
    return {name: get_head(name).init(gen, cfg).to(dev) for name in names}


@torch.no_grad()
def run_heads(cnn, head_bank: dict, z, tasks, cfg: HeadConfig) -> dict:
    """Run each requested head once over the (restored) tensor ``z``, on its
    device.

    Returns {task: np.ndarray} with the batch dimension leading, each head's
    output copied to the host once; iteration is over the sorted task list
    so output construction is deterministic.
    """
    out = {}
    for task in sorted(set(tasks)):
        y = get_head(task).forward(cnn, head_bank[task], z, cfg)
        out[task] = y.cpu().numpy()
    return out
