"""Feed-forward variants: SwiGLU (qwen2), GELU (tanh approximation) and
squared ReLU (RWKV channel mix, nemotron-4). Counterpart of
``repro/models/ffn.py``; weights in the JAX (in, out) layout."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.api import shard_hidden, weight
from repro_torch.nn import frozen, normal, squared_relu

ACTS = ("swiglu", "gelu", "sq_relu")


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 dtype=torch.float32, gen=None, device=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown act {act!r}")
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.act = act
        self.wup = frozen(normal((d_model, d_ff), **kw))
        self.wdown = frozen(normal((d_ff, d_model), **kw))
        if act == "swiglu":
            self.wgate = frozen(normal((d_model, d_ff), **kw))


def ffn_apply(p: FFN, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    up = x @ weight(p.wup, dtype)
    up = shard_hidden(up, "batch", None, "ffn")
    if p.act == "swiglu":
        gate = x @ weight(p.wgate, dtype)
        gate = shard_hidden(gate, "batch", None, "ffn")
        h = F.silu(gate) * up
    elif p.act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        h = squared_relu(up)
    return h @ weight(p.wdown, dtype)
