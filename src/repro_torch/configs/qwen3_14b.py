"""Qwen3-14B: dense decoder, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family]."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense", d_model=5120, vocab_size=151936,
        blocks=uniform_blocks(Block("attn", "dense"), 40),
        num_heads=40, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0, d_ff=17408, mlp_act="silu", carry_shard="seq",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-reduced", family="dense", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64, qk_norm=True,
        d_ff=512, mlp_act="silu",
    )
