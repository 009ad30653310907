"""ResNet for the paper's own experiments (ResNet18-CIFAR10, Sec 4).

Pre-activation ResNet with GroupNorm in place of BatchNorm (the standard
substitution for decentralized training with small local batches), ported
from ``repro.models.resnet``.  The public functions keep the JAX package's
layout so the two compare like with like: images are NHWC, conv weights
HWIO, and the parameter tree has the same structure, shapes and dtypes.
``apply_resnet`` permutes to NCHW/OIHW inside.

Padding follows XLA's ``"SAME"`` rule: the total padding
``max((ceil(h/s) - 1) * s + k - h, 0)`` is split with the smaller half in
front, so a 3x3 stride-2 conv over an even input pads (0, 1), not (1, 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import grad_and_value, vmap

from ..core.simulator import SplitGradFn
from ..core.tree import PyTree, tree_flatten


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    width: int = 64
    num_classes: int = 10
    groups: int = 8  # groupnorm groups


def resnet18_cifar() -> ResNetConfig:
    return ResNetConfig("resnet18", (2, 2, 2, 2), 64, 10)


def resnet8_cifar() -> ResNetConfig:
    """Small stand-in of the same family (3 stages x 1 block)."""
    return ResNetConfig("resnet8", (1, 1, 1), 16, 10, groups=4)


def init_resnet(generator: torch.Generator, cfg: ResNetConfig) -> dict:
    """Random weights on the generator's device, He-normal convs.  The
    structure equals the JAX ``init_resnet``'s; the values do not (torch
    generators are not JAX keys — carry JAX weights with ``convert``)."""
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    def conv(shape):
        return normal(shape) * math.sqrt(2.0 / math.prod(shape[:-1]))

    def gn(c):
        return (torch.ones(c, device=dev), torch.zeros(c, device=dev))

    p: dict = {"stem": conv((3, 3, 3, cfg.width)), "stem_gn": gn(cfg.width)}
    c_in = cfg.width
    p["stages"] = []
    for si, n_blocks in enumerate(cfg.stage_sizes):
        c_out = cfg.width * (2 ** si)
        stage = []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"conv1": conv((3, 3, c_in, c_out)), "gn1": gn(c_in),
                   "conv2": conv((3, 3, c_out, c_out)), "gn2": gn(c_out)}
            # stride-2 blocks are exactly the projected ones in these
            # configs, so `stride` stays out of the param tree
            if stride != 1 or c_in != c_out:
                blk["proj"] = conv((1, 1, c_in, c_out))
            stage.append(blk)
            c_in = c_out
        p["stages"].append(stage)
    p["head"] = (normal((c_in, cfg.num_classes)) / math.sqrt(c_in),
                 torch.zeros(cfg.num_classes, device=dev))
    return p


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """NCHW activations, HWIO weights, XLA "SAME" padding."""
    kh, kw = w_hwio.shape[:2]
    top, bottom = _same_pad(x.shape[-2], kh, stride)
    left, right = _same_pad(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, scale, bias, groups: int) -> torch.Tensor:
    """GroupNorm over contiguous channel groups, biased variance, eps 1e-5."""
    return F.group_norm(x, groups, scale, bias, eps=1e-5)


def apply_resnet(p: dict, cfg: ResNetConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """x: (B, 32, 32, 3) NHWC -> logits (B, num_classes)."""
    # a permuted NHWC view would carry channels-last strides through every
    # conv; PyTorch 2.13's CPU conv backward can crash on that layout
    # (1x1 stride-2 projection), so the activations are made NCHW here
    h = _conv(x.permute(0, 3, 1, 2).contiguous(), p["stem"])
    for stage in p["stages"]:
        for blk in stage:
            g = cfg.groups
            stride = 2 if "proj" in blk else 1
            y = F.relu(_gn(h, *blk["gn1"], g))
            shortcut = _conv(y, blk["proj"], stride) if "proj" in blk else h
            y = _conv(y, blk["conv1"], stride)
            y = F.relu(_gn(y, *blk["gn2"], g))
            y = _conv(y, blk["conv2"])
            h = shortcut + y
    h = F.relu(h).mean(dim=(2, 3))
    w, b = p["head"]
    return h @ w + b


def resnet_loss(p: dict, cfg: ResNetConfig, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    logits = apply_resnet(p, cfg, batch["images"])
    lp = F.log_softmax(logits, dim=-1)
    ce = -lp.gather(-1, batch["labels"][:, None].long()).mean()
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return ce, {"acc": acc}


def resnet_grad_fn(cfg: ResNetConfig, stream) -> SplitGradFn:
    """Batched ``grad_fn`` for ``Simulator`` (see ``simulator.GradFn``),
    split into its draw and its use (``simulator.SplitGradFn``) so that the
    sharded replay draws the single-device batches.

    ``stream.sample_workers(generator, n)`` draws one batch per worker,
    ``{"images": (n, B, 32, 32, 3), "labels": (n, B)}``, outside the vmap;
    the per-worker loss and gradient are then one ``torch.func.vmap`` of
    ``grad_and_value`` over the stacked parameters of the given rows.
    """
    def loss_one(p, images, labels):
        return resnet_loss(p, cfg, {"images": images, "labels": labels})[0]

    per_worker = vmap(grad_and_value(loss_one))

    def apply(x_stacked, batch, worker_ids):
        grads, losses = per_worker(x_stacked, batch["images"],
                                   batch["labels"])
        return losses, grads

    return SplitGradFn(stream.sample_workers, apply)


class ResNet(nn.Module):
    """``nn.Module`` holding one replica's parameters in the JAX tree's
    leaf order; ``forward`` is ``apply_resnet`` on them (NHWC images)."""

    def __init__(self, cfg: ResNetConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        leaves, self._treedef = tree_flatten(params)
        self.leaves = nn.ParameterList(nn.Parameter(a) for a in leaves)

    def params(self) -> PyTree:
        return self._treedef.unflatten(list(self.leaves))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply_resnet(self.params(), self.cfg, images)
