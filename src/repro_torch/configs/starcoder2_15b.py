"""StarCoder2-15B [arXiv:2402.19173]: dense GQA, RoPE, GELU, LayerNorm, bias."""
from repro_torch.configs.base import ArchConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab=49152, act="gelu", qkv_bias=True,
        rope_theta=100_000.0, norm="layernorm",
        note="GQA kv=4; standard MLP w/ GELU; LayerNorm",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512)
