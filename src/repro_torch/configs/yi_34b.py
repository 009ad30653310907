"""Yi-34B: llama-arch dense decoder, GQA kv=8 [arXiv:2403.04652]."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", d_model=7168, vocab_size=64000,
        blocks=uniform_blocks(Block("attn", "dense"), 60),
        num_heads=56, num_kv_heads=8, head_dim=128,
        rope_theta=5_000_000.0, d_ff=20480, mlp_act="silu", carry_shard="seq",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-reduced", family="dense", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, mlp_act="silu",
    )
