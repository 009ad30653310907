"""Qwen3-0.6B: dense decoder, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family]."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense", d_model=1024, vocab_size=151936,
        blocks=uniform_blocks(Block("attn", "dense"), 28),
        num_heads=16, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0, d_ff=3072, mlp_act="silu",
        tie_embeddings=True, carry_shard="seq",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-reduced", family="dense", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64, qk_norm=True,
        d_ff=512, mlp_act="silu", tie_embeddings=True,
    )
