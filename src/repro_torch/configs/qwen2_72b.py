"""Qwen2-72B [arXiv:2407.10671]: dense GQA, QKV bias, SwiGLU."""
from repro_torch.configs.base import ArchConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, act="swiglu", qkv_bias=True,
        rope_theta=1_000_000.0, norm="rmsnorm",
        serve_weight_sharding="2d",
        note="GQA kv=8; QKV bias per Qwen2 report",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=512)
