"""The benchmark's inputs, made from ``--seed``: the event schedule
(``schedule.py``) and one stream of batches per kind of data, found by
the ``stream.kind`` of a cell's workload file.

A stream's ``batch(tick)`` is the whole (workers, ...) batch of one
gradient tick, a function of the seed and the tick's index alone, so the
reference draws what the program drew.  ``sample_workers(generator, n)``
is the same batches in tick order, the port's ``grad_fn`` interface; the
port's generator is not used.
"""
from __future__ import annotations

import numpy as np

# tags that keep the seed's uses apart
WEIGHTS, SCHEDULE, DATA, TICK = 1, 2, 3, 4


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed`` (any size of whole number)."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *tags]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31 ^ int(words[1])) & ((1 << 63) - 1)


class TickStream:
    """``sample_workers`` over ``batch``: each call is the next tick."""

    tick = 0

    def batch(self, tick: int) -> dict:
        raise NotImplementedError

    def sample_workers(self, generator, n: int) -> dict:
        out = self.batch(self.tick)
        self.tick += 1
        return out
