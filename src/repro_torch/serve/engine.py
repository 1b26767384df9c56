"""Serving steps: prefill, one-token decode, and chunked long-context
ingestion for the ssm family.

Counterpart of ``repro/serve/engine.py``. Long-context ingestion walks the
sequence in blocks so that activation memory is O(block), not O(S): per
block, embed -> every layer's ``rwkv6_block_chunk`` carrying its recurrent
state (wkv state and the two token-shift carries) -> the next block. It
returns the last token's logits and the states, ready to decode at
position S. The zamba2 (hybrid) branch with its windowed shared attention
comes with the hybrid archs (ROADMAP Queue 1 step 9).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import (LM, check_family, lm_decode_step,
                                   lm_forward, lm_logits)
from repro_torch.models.rwkv6 import (RWKV6State, init_rwkv6_state,
                                      rwkv6_block_chunk)


def make_prefill_step(cfg: ArchConfig):
    """-> prefill(model, batch) -> logits (B, S, V); batch holds ``tokens``
    (B, S) or ``embeds`` (B, S, D)."""
    check_family(cfg)

    def prefill(model: LM, batch: dict):
        logits, _ = lm_forward(model, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))
        return logits
    return prefill


def make_decode_step(cfg: ArchConfig):
    """-> step(model, cache, token) -> (logits (B, V), new cache)."""
    check_family(cfg)

    def step(model: LM, cache, token):
        return lm_decode_step(model, cache, token)
    return step


class LongState(NamedTuple):
    layer_states: list          # [RWKV6State] per layer
    block_idx: int = 0


def _check_long(cfg: ArchConfig) -> None:
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid long ingestion (zamba2) comes with the hybrid archs "
            "(ROADMAP Queue 1 step 9)")
    if cfg.family != "ssm":
        raise ValueError("long ingestion is sub-quadratic only (ssm/hybrid)")


def init_long_state(cfg: ArchConfig, batch: int, block: int,
                    device=None) -> LongState:
    _check_long(cfg)
    dev = resolve_device(device)
    return LongState(layer_states=[
        init_rwkv6_state(batch, cfg.d_model, cfg.ssm.head_dim, cfg.dtype,
                         device=dev) for _ in range(cfg.n_layers)])


def make_long_ingest(cfg: ArchConfig, *, block: int = 8192):
    """-> ingest(model, tokens (B, S)) -> (last-token logits (B, V),
    LongState). S must be a multiple of ``block``."""
    _check_long(cfg)

    @torch.no_grad()
    def ingest(model: LM, tokens: torch.Tensor):
        b, s = tokens.shape
        if s == 0 or s % block:
            raise ValueError(f"sequence {s} is not a positive multiple of "
                             f"block {block}")
        st = init_long_state(cfg, b, block, device=model.device)
        states = st.layer_states
        for i in range(s // block):
            x = model.embed[tokens[:, i * block:(i + 1) * block]].to(cfg.dtype)
            new_states: list[RWKV6State] = []
            for lp, lst in zip(model.layers, states):
                x, lst = rwkv6_block_chunk(lp, x, lst,
                                           head_dim=cfg.ssm.head_dim,
                                           chunk=cfg.ssm.chunk,
                                           dtype=cfg.dtype)
                new_states.append(lst)
            states = new_states
        # the JAX package takes every block's last logits and keeps the
        # final block's; only that one is computed here
        logits = lm_logits(model, model.final_norm(x[:, -1:, :]))[:, 0]
        return logits, LongState(layer_states=states, block_idx=s // block)

    return ingest
