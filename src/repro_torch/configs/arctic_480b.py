"""Snowflake Arctic (480B): dense-MoE hybrid — 128 experts top-2 with a
parallel dense residual MLP [hf:Snowflake/snowflake-arctic-base]."""
from ..models.config import Block, MoEConfig, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", d_model=7168, vocab_size=32000,
        blocks=uniform_blocks(Block("attn", "moe+dense"), 35),
        num_heads=56, num_kv_heads=8, head_dim=128,
        rope_theta=10_000.0, d_ff=4864, mlp_act="silu",
        moe=MoEConfig(num_experts=128, top_k=2, d_expert=4864,
                      dense_d_ff=4864, capacity_factor=1.25),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced", family="moe", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("attn", "moe+dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, mlp_act="silu",
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=512, dense_d_ff=512),
    )
