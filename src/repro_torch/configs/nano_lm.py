"""nano-lm: ~100M-parameter dense LM for CPU-runnable end-to-end examples."""
from ..models.config import Block, ModelConfig, uniform_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="nano-lm", family="dense", d_model=768, vocab_size=32000,
        blocks=uniform_blocks(Block("attn", "dense"), 12),
        num_heads=12, num_kv_heads=4, head_dim=64,
        d_ff=3072, mlp_act="silu", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nano-lm-reduced", family="dense", d_model=128, vocab_size=256,
        blocks=uniform_blocks(Block("attn", "dense"), 2),
        num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, mlp_act="silu", tie_embeddings=True,
    )


def train_bench() -> ModelConfig:
    """Micro variant for ``benchmarks/run.py --only train``: same block
    structure as nano-lm but small enough (~45k params) that an n=64,
    36-world batched replay of the full per-worker state fits CPU memory."""
    return ModelConfig(
        name="nano-lm-bench", family="dense", d_model=64, vocab_size=128,
        blocks=uniform_blocks(Block("attn", "dense"), 1),
        num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, mlp_act="silu", tie_embeddings=True,
    )
