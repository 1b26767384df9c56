"""Zamba2-1.2B [arXiv:2411.15242]: Mamba-2 backbone + shared attention block.

The shared full-attention+MLP block (weights reused at every application) runs
every ``shared_attn_every`` Mamba-2 layers; in long-context mode it switches to
windowed attention (window=4096) so the whole model stays sub-quadratic,
where the paper's shared block attends to the whole context."""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000, act="gelu", qkv_bias=False,
        rope_theta=10_000.0, norm="rmsnorm",
        ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                      conv_width=4, chunk=128),
        hybrid=HybridConfig(shared_attn_every=6, attn_window_long=4096),
        note="38 mamba2 layers; shared MHA(32h,d64)+MLP(8192) block every 6 "
             "layers; windowed attn in long-context mode",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        ssm=SSMConfig(kind="mamba2", state_dim=16, head_dim=16, expand=2,
                      conv_width=4, chunk=8),
        hybrid=HybridConfig(shared_attn_every=2, attn_window_long=16))
