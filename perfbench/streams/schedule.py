"""The event schedule of a cell: the traffic of a gossip replay.

A frozen copy of the Poisson emulation the paper describes (App E.2) and
the port implements: a round is one unit of simulated time; in round r the
number of matching events is Poisson(comms_per_grad), each at a uniform
time in [r, r + 1), each a maximal matching taken by scanning the graph's
edges in a random order; every worker's gradient tick lands at a jittered
time in the second half of the round, after the round's last event.  Only
uniform edge rates are drawn (every graph here has them).

The arrays are the benchmark's own; the harness builds the port's
``Schedule`` from them, and the reference replays them event by event.

``stratified_counts`` gives a block of rounds the same counts for every
seed in a seed-drawn order: the Poisson quantiles at (i + 1/2) / R.  Each
call of a cell then carries the same number of events whatever the seed,
and only their order, times and pairs change with it; the first three
rounds at one comm a gradient hold counts {0, 1, 2}, so an event always
falls in the second or third.
"""
from __future__ import annotations

import math

import numpy as np


def graph_edges(name: str, n: int) -> tuple[list[tuple[int, int]], float]:
    """(edges, the rate of each edge) of a graph with one expected
    averaging a worker per unit time, as the port's ``build_graph``."""
    if name == "ring":
        if n == 2:
            return [(0, 1)], 1.0
        return [(min(i, (i + 1) % n), max(i, (i + 1) % n))
                for i in range(n)], 0.5
    if name == "complete":
        return [(i, j) for i in range(n) for j in range(i + 1, n)], \
            1.0 / (n - 1)
    if name == "exponential":
        edges = set()
        k = 0
        while (1 << k) < n:
            for i in range(n):
                j = (i + (1 << k)) % n
                if i != j:
                    edges.add((min(i, j), max(i, j)))
            k += 1
        edges = sorted(edges)
        return edges, n / (2 * len(edges))
    raise ValueError(f"unknown graph {name!r}")


def _matching(edges, n: int, rng: np.random.Generator) -> np.ndarray:
    """partner[i] = j for a matched pair, i for an idle worker."""
    order = rng.permutation(len(edges))
    used = np.zeros(n, dtype=bool)
    partner = np.arange(n, dtype=np.int32)
    for k in order:
        i, j = edges[int(k)]
        if not (used[i] or used[j]):
            used[i] = used[j] = True
            partner[i], partner[j] = j, i
    return partner


def stratified_counts(lam: float, rounds: int, rng: np.random.Generator
                      ) -> np.ndarray:
    """The Poisson(lam) quantiles at (i + 1/2) / rounds, in an order drawn
    from ``rng``."""
    cdf, k, p, out = 0.0, 0, math.exp(-lam), []
    for i in range(rounds):
        while cdf + p < (i + 0.5) / rounds:
            cdf += p
            k += 1
            p *= lam / k
        out.append(k)
    return rng.permutation(np.array(out, dtype=np.int64))


def sample(graph: str, n: int, rounds: int, comms_per_grad: float,
           rng: np.random.Generator, counts: np.ndarray | None = None
           ) -> dict[str, np.ndarray]:
    """``rounds`` rounds of events from ``rng``: ``partners`` (R, K, n)
    int32, ``event_times`` (R, K) f32, ``event_mask`` (R, K) bool,
    ``grad_times`` (R, n) f32, with K the most events of any round.
    ``counts`` (R,) fixes the events of each round, else they are drawn
    Poisson(comms_per_grad)."""
    edges, _ = graph_edges(graph, n)
    if counts is None:
        counts = rng.poisson(lam=comms_per_grad, size=rounds)
    kmax = max(1, int(counts.max()))
    partners = np.tile(np.arange(n, dtype=np.int32), (rounds, kmax, 1))
    event_times = np.zeros((rounds, kmax), dtype=np.float32)
    event_mask = np.zeros((rounds, kmax), dtype=bool)
    for r in range(rounds):
        k = int(counts[r])
        times = np.sort(rng.uniform(r, r + 1, size=k)).astype(np.float32)
        last = np.float32(r)
        for e in range(kmax):
            if e < k:
                partners[r, e] = _matching(edges, n, rng)
                event_times[r, e] = times[e]
                event_mask[r, e] = True
                last = times[e]
            else:
                event_times[r, e] = last
    grad_times = np.zeros((rounds, n), dtype=np.float32)
    for r in range(rounds):
        grad_times[r] = (r + 0.5 + 0.5 * rng.uniform(size=n)).astype(
            np.float32)
        grad_times[r] = np.maximum(grad_times[r],
                                   event_times[r].max() + 1e-4)
    return {"partners": partners, "event_times": event_times,
            "event_mask": event_mask, "grad_times": grad_times}


def rounds_slice(arrays: dict, start: int, stop: int) -> dict:
    return {k: v[start:stop] for k, v in arrays.items()}
