"""RecurrentGemma-9B: RG-LRU + local attention in a 2:1 pattern
[arXiv:2402.19427].  38 layers = (rglru, rglru, local-attn) x 12 +
(rglru, rglru); local attention window 2048, MQA (kv=1)."""
from ..models.config import Block, ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    rec = Block("rglru", "dense")
    loc = Block("attn", "dense", window=2048)
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", d_model=4096,
        vocab_size=256000,
        blocks=(((rec, rec, loc), 12), ((rec, rec), 1)),
        num_heads=16, num_kv_heads=1, head_dim=256,
        rope_theta=10_000.0, d_ff=12288, mlp_act="silu",
        rglru=RGLRUConfig(d_rnn=4096, conv_width=4, c=8.0),
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    rec = Block("rglru", "dense")
    loc = Block("attn", "dense", window=32)
    return ModelConfig(
        name="recurrentgemma-9b-reduced", family="hybrid", d_model=256,
        vocab_size=512,
        blocks=(((rec, rec, loc), 1),),
        num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=512, mlp_act="silu",
        rglru=RGLRUConfig(d_rnn=256, conv_width=4, c=8.0),
        tie_embeddings=True,
    )
