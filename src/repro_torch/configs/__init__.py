"""Architecture registry: one module per assigned architecture.

Every module exposes ``config()`` (the exact assigned configuration) and
``reduced()`` (a smoke-test variant of the same family: <=2 layers,
d_model<=512, <=4 experts) plus cites its source in the module docstring.
"""
from __future__ import annotations

import importlib

ARCHITECTURES = (
    "musicgen-medium",
    "arctic-480b",
    "mamba2-780m",
    "chameleon-34b",
    "deepseek-v3-671b",
    "recurrentgemma-9b",
    "qwen3-14b",
    "glm4-9b",
    "yi-34b",
    "qwen3-0.6b",
)

EXTRA = ("nano-lm", "paper-resnet18")  # paper repro + example-scale configs


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str, reduced: bool = False):
    mod = _module(name)
    return mod.reduced() if reduced else mod.config()


def list_architectures() -> tuple[str, ...]:
    return ARCHITECTURES
