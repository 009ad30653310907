"""Models: the paper's ResNet for CIFAR, and the transformer family
(``config``, ``layers`` with the MoE, ``attention`` with GQA and MLA,
``ssm`` (Mamba-2 SSD), ``rglru`` (RecurrentGemma's RG-LRU) and
``transformer``, with multi-token prediction)."""
from . import attention, layers, rglru, ssm, transformer
from .config import (Block, MLAConfig, MoEConfig, ModelConfig, RGLRUConfig,
                     SSMConfig)
from .transformer import Model

__all__ = ["Block", "MLAConfig", "MoEConfig", "ModelConfig", "RGLRUConfig",
           "SSMConfig", "Model", "attention", "layers", "rglru", "ssm",
           "transformer"]
