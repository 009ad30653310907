"""Pre-activation ResNet-18 for 32x32 images, plain PyTorch, float32.

He et al. (arXiv:1512.03385, v2's pre-activation order) as the A2CiD2
paper trains it on CIFAR-10, with the port's two departures: GroupNorm
(``groups`` groups, eps 1e-5) in place of BatchNorm, and 'SAME' padding
(the total ``max((ceil(h/s) - 1) s + k - h, 0)`` split with the smaller
half in front, so a 3x3 stride-2 convolution over an even input pads
(0, 1)).  Images are NHWC, weights HWIO, as the benchmark made them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    k = w.shape[0]
    pads = []
    for size in (x.shape[3], x.shape[2]):          # width, then height
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w.permute(3, 2, 0, 1), stride=stride)


def logits(p: dict, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    g = cfg["groups"]
    h = _conv(images.permute(0, 3, 1, 2), p["stem"])
    for stage in p["stages"]:
        for blk in stage:
            stride = 2 if "proj" in blk else 1
            y = F.relu(F.group_norm(h, g, *blk["gn1"], eps=1e-5))
            short = _conv(y, blk["proj"], stride) if "proj" in blk else h
            y = _conv(y, blk["conv1"], stride)
            y = F.relu(F.group_norm(y, g, *blk["gn2"], eps=1e-5))
            h = short + _conv(y, blk["conv2"])
    w, b = p["head"]
    return F.relu(h).mean(dim=(2, 3)) @ w + b


def loss(p: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of one worker's (B, 32, 32, 3) images."""
    return F.cross_entropy(logits(p, cfg, batch["images"]),
                           batch["labels"])
