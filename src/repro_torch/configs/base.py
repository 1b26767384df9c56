"""Unified architecture config of the LM zoo.

Counterpart of ``repro/configs/base.py``: one dataclass describes every
assigned architecture, with optional family sub-configs (MoE, SSM, hybrid
schedule, encoder-decoder). The dtypes are torch's: ``dtype`` (compute, and
the storage of weights every use casts to it) is ``torch.bfloat16`` and
``param_dtype`` (norm scales and biases, RWKV's ``w0`` and ``u``) is
``torch.float32``. The parameter counts are the JAX package's formulas.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Assigned input shapes (identical for every LM arch)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="long"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"           # 'mamba2' | 'rwkv6'
    state_dim: int = 64            # N (mamba2) / head key dim (rwkv6)
    head_dim: int = 64
    expand: int = 2                # mamba2 inner expansion
    conv_width: int = 4            # mamba2 depthwise conv
    chunk: int = 128               # chunked-scan block length
    decay_lora: int = 64           # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class HybridConfig:
    shared_attn_every: int = 6     # zamba2: shared attn block cadence
    attn_window_long: int = 4_096  # windowed attention in long-context mode


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 4
    dec_layers: int = 4
    cross_attention: bool = True
    enc_len_decode: int = 1_500    # encoder length used for decode cells


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"             # swiglu | gelu | sq_relu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_inputs: bool = True       # False: inputs are precomputed embeds
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    serve_weight_sharding: str = "tp"
    attn_window: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    norm_grad: str = "f32"
    note: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def supported_shapes(self) -> Tuple[str, ...]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.subquadratic:
            out.append("long_500k")
        return tuple(out)

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.hd
    return cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * hd * cfg.d_model


def _ffn_params(cfg: ArchConfig, d_ff=None) -> int:
    d_ff = d_ff or cfg.d_ff
    return (3 if cfg.act == "swiglu" else 2) * cfg.d_model * d_ff


def _rwkv6_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    s = cfg.ssm or SSMConfig()
    return 6 * d * d + 2 * d * cfg.d_ff + 2 * 5 * 32 * d \
        + 2 * s.decay_lora * d


def _mamba2_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    proj_out = 2 * d_inner + 2 * s.state_dim + n_heads
    return d * (d_inner + proj_out - d_inner) + d * d_inner \
        + d_inner * d + s.conv_width * (d_inner + 2 * s.state_dim)


def _embed_params(cfg: ArchConfig) -> int:
    return cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def param_count_dense(cfg: ArchConfig) -> int:
    """Analytic parameter count (MODEL_FLOPS = 6*N*D). ssm counts RWKV-6
    blocks; hybrid counts Mamba-2 blocks and ONE shared attention block."""
    emb = _embed_params(cfg)
    if cfg.family == "ssm":
        return cfg.n_layers * _rwkv6_layer_params(cfg) + emb
    if cfg.family == "hybrid":
        shared = _attn_params(cfg) + _ffn_params(cfg)
        return cfg.n_layers * _mamba2_layer_params(cfg) + shared + emb
    per_layer = _attn_params(cfg) + _ffn_params(cfg) + 2 * cfg.d_model
    return cfg.n_layers * per_layer + emb


def _moe_layer_params(cfg: ArchConfig, n_experts: int) -> int:
    ffn_factor = 3 if cfg.act == "swiglu" else 2
    ffn = n_experts * ffn_factor * cfg.d_model * cfg.moe.d_ff_expert
    if cfg.moe.dense_residual:
        ffn += ffn_factor * cfg.d_model * cfg.d_ff
    router = cfg.d_model * cfg.moe.num_experts
    return _attn_params(cfg) + ffn + router + 2 * cfg.d_model


def active_param_count(cfg: ArchConfig) -> int:
    """Per-token parameters: MoE counts only top_k experts; the hybrid
    shared block counts once per application."""
    if cfg.family == "hybrid":
        n_apps = -(-cfg.n_layers // (cfg.hybrid.shared_attn_every
                                     if cfg.hybrid else 6))
        shared = _attn_params(cfg) + _ffn_params(cfg)
        return cfg.n_layers * _mamba2_layer_params(cfg) \
            + n_apps * shared + _embed_params(cfg)
    if cfg.moe is None:
        return param_count_dense(cfg)
    return cfg.n_layers * _moe_layer_params(cfg, cfg.moe.top_k) \
        + _embed_params(cfg)


def total_param_count(cfg: ArchConfig) -> int:
    if cfg.moe is None:
        return param_count_dense(cfg)
    return cfg.n_layers * _moe_layer_params(cfg, cfg.moe.num_experts) \
        + _embed_params(cfg)
