"""MusicGen-medium: decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284].  Backbone only: the EnCodec/conditioning frontend is
stubbed — input_specs() provides precomputed frame embeddings (B,S,D); the
LM head predicts all 4 codebooks in parallel (delay pattern handled by the
data pipeline)."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio", d_model=1536, vocab_size=2048,
        blocks=uniform_blocks(Block("attn", "dense"), 48),
        num_heads=24, num_kv_heads=24, head_dim=64,
        rope_theta=10_000.0, d_ff=6144, mlp_act="gelu", carry_shard="seq",
        input_mode="embeddings", num_codebooks=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-reduced", family="audio", d_model=256,
        vocab_size=128,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, mlp_act="gelu", input_mode="embeddings", num_codebooks=4,
    )
