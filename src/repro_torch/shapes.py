"""Assigned input shapes and their meta-tensor stand-ins for the dry run,
ported from ``repro.shapes``.

The four assigned shapes:
  train_4k     seq=4096    global_batch=256   (training       -> train_step)
  prefill_32k  seq=32768   global_batch=32    (prefill        -> prefill_step)
  decode_32k   seq=32768   global_batch=128   (decode         -> serve_step)
  long_500k    seq=524288  global_batch=1     (long decode    -> serve_step,
                                               sub-quadratic carve-out)

The JAX package's ``ShapeDtypeStruct``s are tensors on ``device="meta"``
here: shape and dtype, no storage, and every op on them runs its shape
function only.
"""
from __future__ import annotations

import dataclasses

import torch

from .models.config import ModelConfig
from .models.layers import dtype_of
from .models.transformer import Model

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_for(name: str) -> InputShape:
    return SHAPES[name]


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-driven config adaptation: long_500k forces the sub-quadratic
    sliding-window variant on attention blocks (SSM/RG-LRU are already
    sub-quadratic and unaffected)."""
    if shape.name == "long_500k":
        return cfg.windowed()
    return cfg


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        inputs = _meta((b, s), torch.int32)
    else:  # stubbed frontend: precomputed frame/patch embeddings
        inputs = _meta((b, s, cfg.d_model), dtype_of(cfg.compute_dtype))
    if cfg.num_codebooks > 1:
        labels = _meta((b, s, cfg.num_codebooks), torch.int32)
    else:
        labels = _meta((b, s), torch.int32)
    return {"inputs": inputs, "labels": labels}


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """One new token against a seq_len-deep cache."""
    b = shape.global_batch
    if cfg.input_mode == "tokens":
        inputs = _meta((b, 1), torch.int32)
    else:
        inputs = _meta((b, 1, cfg.d_model), dtype_of(cfg.compute_dtype))
    return {"inputs": inputs, "pos": _meta((), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: InputShape, dtype=None) -> list:
    """The decode caches on the meta device (no allocation)."""
    return Model(cfg).init_cache(shape.global_batch, shape.seq_len, dtype,
                                 device=META)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    shape = shape_for(shape_name)
    cfg = adapt_config(cfg, shape)
    if shape.kind in ("train", "prefill"):
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
