"""Models: the paper's ResNet for CIFAR, and the dense GQA transformer
family (``config``, ``layers``, ``attention``, ``transformer``)."""
from .config import (Block, MLAConfig, MoEConfig, ModelConfig, RGLRUConfig,
                     SSMConfig)
from .transformer import Model

__all__ = ["Block", "MLAConfig", "MoEConfig", "ModelConfig", "RGLRUConfig",
           "SSMConfig", "Model"]
