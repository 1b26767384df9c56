"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: dense-MoE
hybrid — 128-expert top-2 MoE in parallel with a dense residual FFN."""
from repro_torch.configs.base import ArchConfig, MoEConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=4864, vocab=32000, act="swiglu", qkv_bias=False,
        rope_theta=10_000.0, norm="rmsnorm",
        moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True),
        serve_weight_sharding="2d",
        note="GQA kv=8; 128e top-2 + parallel dense residual FFN (d_ff=4864)",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      dense_residual=True))
