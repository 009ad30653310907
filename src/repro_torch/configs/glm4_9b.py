"""GLM-4-9B: dense decoder, GQA kv=2, partial RoPE [hf:THUDM/glm-4-9b]."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense", d_model=4096, vocab_size=151552,
        blocks=uniform_blocks(Block("attn", "dense"), 40),
        num_heads=32, num_kv_heads=2, head_dim=128,
        rope_theta=10_000.0, rope_fraction=0.5, d_ff=13696, mlp_act="silu", carry_shard="seq",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-reduced", family="dense", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64, rope_fraction=0.5,
        d_ff=512, mlp_act="silu",
    )
