"""Nemotron-4-15B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP, huge vocab."""
from repro_torch.configs.base import ArchConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=256_000, act="sq_relu", qkv_bias=False,
        rope_theta=10_000.0, norm="layernorm",
        note="GQA kv=8; squared-ReLU; 256k SentencePiece vocab",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=1024)
