"""Mamba2-780m: attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from ..models.config import Block, ModelConfig, SSMConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", d_model=1536, vocab_size=50280,
        blocks=uniform_blocks(Block("ssd", "none"), 48),
        num_heads=1, num_kv_heads=1,  # unused (attention-free)
        d_ff=0,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                      conv_width=4, chunk=128),
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-reduced", family="ssm", d_model=256, vocab_size=512,
        blocks=uniform_blocks(Block("ssd", "none"), 2),
        num_heads=1, num_kv_heads=1, d_ff=0,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, n_groups=1,
                      conv_width=4, chunk=32),
        tie_embeddings=True,
    )
