"""Qwen2-7B [arXiv:2407.10671]: dense GQA, QKV bias, SwiGLU."""
from repro_torch.configs.base import ArchConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064, act="swiglu", qkv_bias=True,
        rope_theta=1_000_000.0, norm="rmsnorm",
        note="GQA kv=4; QKV bias per Qwen2 report",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=512)
