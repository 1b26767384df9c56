"""Whisper-tiny [arXiv:2212.04356]: 4+4 enc-dec, d=384, MHA, GELU.

Conv audio frontend is a STUB per the assignment: input_specs provide
precomputed frame embeddings (B, S_enc, 384)."""
from repro_torch.configs.base import ArchConfig, EncDecConfig


def full_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=8,  # 4 enc + 4 dec (see encdec)
        d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab=51865, act="gelu", qkv_bias=True,
        rope_theta=10_000.0, norm="layernorm", embed_inputs=False,
        encdec=EncDecConfig(enc_layers=4, dec_layers=4),
        note="enc-dec; conv frontend stubbed (precomputed frame embeddings); "
             "learned positions in decoder, none needed for stub encoder",
    )


def smoke_config() -> ArchConfig:
    return full_config().with_(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        encdec=EncDecConfig(enc_layers=2, dec_layers=2))
