"""Chameleon-34B: early-fusion VLM, VQ image tokens in-vocab, qk-norm
[arXiv:2405.09818].  Backbone only: the VQ image tokenizer frontend is
stubbed — input_specs() provides mixed text+image token ids directly."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm", d_model=8192, vocab_size=65536,
        blocks=uniform_blocks(Block("attn", "dense"), 48),
        num_heads=64, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=10_000.0, d_ff=22016, mlp_act="silu", carry_shard="seq",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced", family="vlm", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64, qk_norm=True,
        d_ff=512, mlp_act="silu",
    )
