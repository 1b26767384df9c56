"""RWKV-6 (Finch) 3B [arXiv:2404.05892]: attention-free, data-dependent decay."""
from repro_torch.configs.base import ArchConfig, SSMConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, act="sq_relu", qkv_bias=False,
        rope_theta=10_000.0, norm="layernorm",
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=16, decay_lora=64),
        note="attention-free; wkv heads of dim 64; channel-mix d_ff=8960; "
             "chunk=16 keeps the factorized decay inside fp32 range",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        ssm=SSMConfig(kind="rwkv6", head_dim=16, chunk=8, decay_lora=8))
