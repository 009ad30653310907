"""DeepSeek-V3 (671B): MLA attention, 1 shared + 256 routed experts top-8,
multi-token prediction [arXiv:2412.19437].  First 3 layers dense (d_ff 18432
per the model card), remaining 58 MoE with 2048-dim experts."""
from ..models.config import (Block, MLAConfig, MoEConfig, ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", d_model=7168,
        vocab_size=129280,
        blocks=(((Block("mla", "dense"),), 3),
                ((Block("mla", "moe"),), 58)),
        num_heads=128, num_kv_heads=128,  # MLA: effectively MHA via latents
        rope_theta=10_000.0, d_ff=18432, mlp_act="silu",
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      shared_expert=True, d_shared=2048,
                      capacity_factor=1.25),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mtp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced", family="moe", d_model=256,
        vocab_size=512,
        blocks=(((Block("mla", "dense"),), 1),
                ((Block("mla", "moe"),), 1)),
        num_heads=4, num_kv_heads=4,
        d_ff=512, mlp_act="silu",
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      shared_expert=True, d_shared=128),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        mtp=True,
    )
