"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo-style decoder
backbone; pixtral-ViT vision frontend is a STUB (precomputed patch embeddings
mixed into the sequence per the assignment)."""
from repro_torch.configs.base import ArchConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, act="swiglu", qkv_bias=False,
        rope_theta=1_000_000.0, norm="rmsnorm", embed_inputs=False,
        note="backbone only; vision tower stubbed — inputs are precomputed "
             "(B, S, 5120) embeddings (patch+text), vocab used for the LM head",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=512)
