"""Pre-activation ResNet for 32x32 images (GroupNorm in place of
BatchNorm), in the tree layout of the port's ``models/resnet.py``: HWIO
convolution weights, GroupNorm ``(scale, bias)`` pairs, a stride-2
projection at the first block of every stage but the first."""
from __future__ import annotations

import math

import torch

from ..streams import WEIGHTS, derive

WORK_UNIT = "images"


def _blocks(cfg: dict):
    """(stage, block, c_in, c_out, stride) of every residual block."""
    c_in = cfg["width"]
    for si, n in enumerate(cfg["stage_sizes"]):
        c_out = cfg["width"] * 2 ** si
        for bi in range(n):
            yield si, bi, c_in, c_out, 2 if (si > 0 and bi == 0) else 1
            c_in = c_out


def _shapes(cfg: dict) -> list[tuple[tuple, str]]:
    """Every leaf's shape and its kind, in the tree's order of making."""
    out = [((3, 3, cfg["channels"], cfg["width"]), "conv"),
           ((cfg["width"],), "one"), ((cfg["width"],), "zero")]
    c = cfg["width"]
    for _, _, c_in, c_out, stride in _blocks(cfg):
        out += [((3, 3, c_in, c_out), "conv"), ((c_in,), "one"),
                ((c_in,), "zero"), ((3, 3, c_out, c_out), "conv"),
                ((c_out,), "one"), ((c_out,), "zero")]
        if stride != 1 or c_in != c_out:
            out.append(((1, 1, c_in, c_out), "conv"))
        c = c_out
    return out + [((c, cfg["num_classes"]), "head"),
                  ((cfg["num_classes"],), "zero")]


def param_count(cfg: dict) -> int:
    return sum(math.prod(s) for s, _ in _shapes(cfg))


def init_params(cfg: dict, seed: int, device) -> dict:
    """He-normal convolutions, GroupNorm at (1, 0), a head of N(0, 1/c):
    one normal draw for every weight, carved into the leaves."""
    shapes = _shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, WEIGHTS))
    flat = torch.randn(param_count(cfg), generator=gen, device=device)
    made, off = [], 0
    for shape, kind in shapes:
        a = flat[off:off + math.prod(shape)].view(shape)
        off += a.numel()
        if kind == "conv":
            a.mul_(math.sqrt(2.0 / math.prod(shape[:-1])))
        elif kind == "head":
            a.mul_(1.0 / math.sqrt(shape[0]))
        else:
            a.fill_(1.0 if kind == "one" else 0.0)
        made.append(a)
    it = iter(made)
    p = {"stem": next(it), "stem_gn": (next(it), next(it)), "stages": []}
    for si, bi, c_in, c_out, stride in _blocks(cfg):
        if bi == 0:
            p["stages"].append([])
        blk = {"conv1": next(it), "gn1": (next(it), next(it)),
               "conv2": next(it), "gn2": (next(it), next(it))}
        if stride != 1 or c_in != c_out:
            blk["proj"] = next(it)
        p["stages"][si].append(blk)
    p["head"] = (next(it), next(it))
    return p


def forward_flops_per_image(cfg: dict) -> int:
    """2 x the multiply-adds of every convolution and of the head, at the
    output sizes of 'SAME' padding (ceil(size / stride))."""
    size = cfg["image_size"]
    flops = 2 * 9 * cfg["channels"] * cfg["width"] * size * size
    for _, _, c_in, c_out, stride in _blocks(cfg):
        out = -(-size // stride)
        flops += 2 * 9 * c_in * c_out * out * out          # conv1
        flops += 2 * 9 * c_out * c_out * out * out         # conv2
        if stride != 1 or c_in != c_out:
            flops += 2 * c_in * c_out * out * out          # projection
        size = out
    c = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1)
    return flops + 2 * c * cfg["num_classes"]


def work_per_round(cfg: dict, traffic: dict) -> int:
    return traffic["workers"] * traffic["batch"]


def flops_per_round(cfg: dict, traffic: dict) -> float:
    """Forward and backward, 3x the forward, for every image of a tick."""
    return 3.0 * forward_flops_per_image(cfg) * work_per_round(cfg, traffic)


def program_grad_fn(cfg: dict, stream):
    from repro_torch.models.resnet import ResNetConfig, resnet_grad_fn
    port_cfg = ResNetConfig(cfg["name"], tuple(cfg["stage_sizes"]),
                            cfg["width"], cfg["num_classes"], cfg["groups"])
    return resnet_grad_fn(port_cfg, stream)
