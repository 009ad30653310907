"""Model configuration: a composable block-pattern description.

A copy of ``repro.models.config`` (pure data, no JAX), so that the port's
``get_config(name, reduced)`` equals the JAX package's field for field.

A model is a stack of *layer groups*; each group is a (Block, repeat) pair and
its parameters are stacked along a leading axis, as in the JAX package; the
port's forward pass loops over that axis.  Fields that only steer the JAX
package's sharding (``carry_shard``) are kept so the configs compare equal,
and mean nothing on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "ssd", "rglru"]
Mlp = Literal["dense", "moe", "moe+dense", "none"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual block: token mixer + channel mlp."""

    mixer: Mixer = "attn"
    mlp: Mlp = "dense"
    window: int | None = None  # sliding-window size for local attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 0            # expert hidden dim (0 => use d_ff)
    shared_expert: bool = False  # one always-on shared expert (DeepSeek-V3)
    d_shared: int = 0            # shared expert hidden (0 => d_expert)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss
    dense_d_ff: int = 0          # parallel dense residual MLP (Arctic) hidden
    # port-only fields (the JAX package has none of them; at their defaults
    # every configuration builds the JAX package's model):
    # "softmax" | "sigmoid" (DeepSeek-V3's: experts selected by the scores
    # plus a ``router_bias`` leaf, gated by the unbiased scores)
    scoring: str = "softmax"
    routed_scaling: float = 1.0  # the gates' factor after normalisation
    # (first, count): the experts this chip holds of ``num_experts`` (the
    # expert-parallel share), every held pick computed, no capacity
    # (``kernels.moe_experts``; (0, num_experts) an uncut dropless layer);
    # None: all of them, GShard capacity dispatch
    held: tuple[int, int] | None = None


# MoEConfig's fields that the JAX package's has not
PORT_ONLY_MOE_FIELDS = ("scoring", "routed_scaling", "held")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3)."""

    q_lora_rank: int | None = 1536  # None: q projected from d_model
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (RecurrentGemma / Griffin)."""

    d_rnn: int = 0       # recurrent width (0 => d_model)
    conv_width: int = 4
    c: float = 8.0       # power constant a_t = a^(c * r_t)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    # layer groups: ((unit_of_blocks, repeat), ...).  Each group's params are
    # stacked over `repeat` and the forward pass loops over the unit — e.g.
    # RecurrentGemma is (((rglru, rglru, local_attn), 12), ((rglru, rglru), 1)).
    blocks: tuple[tuple[tuple[Block, ...], int], ...]
    # attention
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0          # 0 => d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # fraction of head dims rotated (GLM-4: 0.5)
    d_ff: int = 0
    mlp_act: str = "silu"      # silu (swiglu) | gelu
    # sub-configs (None when unused)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # I/O
    input_mode: str = "tokens"     # tokens | embeddings (stubbed frontend)
    num_codebooks: int = 1         # musicgen: parallel codebook heads
    tie_embeddings: bool = False
    # long-context decode: window applied to *all* attention blocks when set
    # by the shape adapter (sub-quadratic carve-out for long_500k)
    long_context_window: int = 4096
    # residual-stream (scan carry) sharding: "embed" shards d_model over the
    # model axis (min memory, gathers x per block), "seq" shards the sequence
    # (gathers only k/v per attention — cheaper with GQA), "none" replicates
    carry_shard: str = "embed"
    # multi-token prediction (DeepSeek-V3): extra depth-1 MTP head
    mtp: bool = False
    # attention implementation: "xla" (the plain einsum path) or "pallas"
    # (the flash kernel on the card; its plain version on the CPU)
    attention_impl: str = "xla"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------ api
    @property
    def num_layers(self) -> int:
        return sum(len(unit) * r for unit, r in self.blocks)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab axis shards
        evenly under tensor parallelism (e.g. mamba2's 50280 -> 50432).
        Logits/embeddings use the padded size; token ids never reach the pad."""
        return (self.vocab_size + 255) // 256 * 256

    def with_updates(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def windowed(self, window: int | None = None) -> "ModelConfig":
        """Return a variant where every attention block is sliding-window —
        used for the long_500k decode shape (sub-quadratic carve-out)."""
        w = window or self.long_context_window
        blocks = tuple(
            (tuple(dataclasses.replace(
                b, window=(min(b.window, w) if b.window else w))
                if b.mixer in ("attn", "mla") else b for b in unit), r)
            for unit, r in self.blocks)
        return dataclasses.replace(self, blocks=blocks)

    def all_blocks(self) -> list[Block]:
        out: list[Block] = []
        for unit, r in self.blocks:
            out.extend(list(unit) * r)
        return out

    def validate(self) -> None:
        """Raise ``ValueError`` where the JAX package asserts."""
        if self.num_layers <= 0:
            raise ValueError(f"{self.name}: no layers")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: {self.num_heads} heads do not "
                             f"split into {self.num_kv_heads} KV groups")
        needs = {"mla": "mla", "ssd": "ssm", "rglru": "rglru"}
        for b in self.all_blocks():
            sub = needs.get(b.mixer)
            if sub and getattr(self, sub) is None:
                raise ValueError(f"{self.name}: mixer {b.mixer!r} needs "
                                 f"the {sub!r} sub-config")
            if b.mlp in ("moe", "moe+dense") and self.moe is None:
                raise ValueError(f"{self.name}: mlp {b.mlp!r} needs the "
                                 f"'moe' sub-config")


def uniform_blocks(block: Block, n: int) -> tuple[tuple[tuple[Block, ...], int], ...]:
    return (((block,), n),)
