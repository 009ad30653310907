"""CIFAR-like images on the card: ten Gaussian class prototypes drawn from
the seed, and per tick a label and Gaussian noise for every image of every
worker.  Images are (workers, batch, 32, 32, 3) NHWC f32, labels
(workers, batch) int64."""
from __future__ import annotations

import torch

from . import DATA, TICK, TickStream, derive


class Stream(TickStream):
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.seed = seed
        self.shape = (wl["traffic"]["workers"], wl["traffic"]["batch"])
        self.classes = cfg["num_classes"]
        self.noise = wl["stream"]["noise"]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, DATA))
        size = cfg["image_size"]
        self.protos = torch.randn((self.classes, size, size,
                                   cfg["channels"]), generator=self.gen,
                                  device=device)

    def batch(self, tick: int) -> dict:
        g = self.gen.manual_seed(derive(self.seed, TICK, tick))
        labels = torch.randint(0, self.classes, self.shape, generator=g,
                               device=self.protos.device)
        noise = torch.randn(self.shape + self.protos.shape[1:], generator=g,
                            device=self.protos.device)
        return {"images": self.protos[labels] + self.noise * noise,
                "labels": labels}
