"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE, tiny experts."""
from repro_torch.configs.base import ArchConfig, MoEConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab=50304, act="swiglu", qkv_bias=False,
        rope_theta=10_000.0, norm="rmsnorm",
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
        note="MHA (kv=16); 64 experts top-8, expert d_ff=1024",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
