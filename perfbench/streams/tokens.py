"""Token sequences on the card from a first-order chain: the first token is
uniform over the vocabulary; each next one is ``perm[previous]`` with
probability ``copy_p`` and otherwise uniform, ``perm`` a permutation of
the vocabulary drawn from the seed (O(V) memory; a (V, V) transition
matrix at V = 151,936 would take 92 GB).

A run of copies from a uniform token u at position s puts ``perm^k[u]`` at
position s + k.  So a tick draws its coins and uniforms at once and
applies ``perm^k`` by the bits of k with the table of ``perm^(2^b)``: a
dozen gathers a tick, not one launch a position.  Inputs are (workers,
batch, seq) int64, labels the same sequences one position on."""
from __future__ import annotations

import torch

from . import DATA, TICK, TickStream, derive


class Stream(TickStream):
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        t = wl["traffic"]
        self.seed = seed
        self.workers, self.rows, self.seq = t["workers"], t["batch"], t["seq"]
        self.vocab = cfg["vocab_size"]
        self.copy_p = wl["stream"]["copy_p"]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, DATA))
        perm = torch.randperm(self.vocab, generator=self.gen, device=device)
        self.powers = [perm]
        while (1 << len(self.powers)) <= self.seq:
            self.powers.append(self.powers[-1][self.powers[-1]])

    def sequences(self, tick: int) -> torch.Tensor:
        """(workers * batch, seq + 1) tokens of one tick."""
        g = self.gen.manual_seed(derive(self.seed, TICK, tick))
        dev = self.powers[0].device
        n, s = self.workers * self.rows, self.seq + 1
        uniform = torch.randint(0, self.vocab, (n, s), generator=g,
                                device=dev)
        copy = torch.rand((n, s), generator=g, device=dev) < self.copy_p
        copy[:, 0] = False
        pos = torch.arange(s, device=dev).expand(n, s)
        start = torch.cummax(torch.where(copy, 0, pos), dim=1).values
        k = pos - start
        tok = torch.gather(uniform, 1, start)
        for b, p in enumerate(self.powers):
            tok = torch.where((k >> b) & 1 == 1, p[tok], tok)
        return tok

    def batch(self, tick: int) -> dict:
        tok = self.sequences(tick).reshape(self.workers, self.rows, -1)
        return {"inputs": tok[..., :-1], "labels": tok[..., 1:]}
