"""Communication graphs for decentralized gossip (paper Sec 3.1, App E.1).

The paper models the network as a set of edges ``E`` with per-edge Poisson
communication rates ``lambda_ij``.  The *instantaneous expected Laplacian*

    Lambda = sum_{(i,j) in E} lambda_ij (e_i - e_j)(e_i - e_j)^T          (Def 3.1)

defines the two quantities controlling convergence:

    chi_1 = sup_{||x||=1, x ⟂ 1} 1 / (x^T Lambda x)        (Eq 2, = 1/lambda_2)
    chi_2 = 1/2 max_{(i,j) in E} (e_i-e_j)^T Lambda^+ (e_i-e_j)   (Eq 3)

with chi_2 <= chi_1.  A2CiD2 accelerates the communication complexity from
chi_1 to sqrt(chi_1 * chi_2).

Everything here is plain numpy (host-side graph bookkeeping) — the training
step only consumes small static artifacts (edge list, matchings, chi values).
This module is a copy of ``repro.core.graphs``: the PyTorch port keeps its
own so that importing it never loads JAX, and the parity tests pin the two
to identical results.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

Edge = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A communication topology with per-edge expected rates."""

    n: int
    edges: tuple[Edge, ...]
    # expected number of averaging events per unit time on each edge
    rates: tuple[float, ...]
    name: str = "custom"

    def __post_init__(self):
        for (i, j) in self.edges:
            if not (0 <= i < self.n and 0 <= j < self.n and i != j):
                raise ValueError(f"invalid edge ({i},{j}) for n={self.n}")
        if len(self.rates) != len(self.edges):
            raise ValueError("rates must align with edges")
        seen = set()
        for (i, j) in self.edges:
            key = (min(i, j), max(i, j))
            if key in seen:
                raise ValueError(f"duplicate edge {key}")
            seen.add(key)

    # ---------------------------------------------------------------- basic
    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def neighbors(self, i: int) -> list[int]:
        out = []
        for (a, b) in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.n, self.n))
        for (i, j), r in zip(self.edges, self.rates):
            A[i, j] += r
            A[j, i] += r
        return A

    # ------------------------------------------------------------ laplacian
    def laplacian(self) -> np.ndarray:
        """Instantaneous expected Laplacian (Def 3.1)."""
        L = np.zeros((self.n, self.n))
        for (i, j), r in zip(self.edges, self.rates):
            L[i, i] += r
            L[j, j] += r
            L[i, j] -= r
            L[j, i] -= r
        return L

    def total_rate(self) -> float:
        """Expected #p2p communications per unit time = Tr(Lambda)/2 (Prop 3.6)."""
        return float(np.trace(self.laplacian())) / 2.0

    def chi1(self) -> float:
        """Algebraic-connectivity term (Eq 2): 1 / (second-smallest eigenvalue)."""
        lam = np.linalg.eigvalsh(self.laplacian())
        lam2 = lam[1]  # smallest is ~0 (connected graph)
        if lam2 <= 1e-12:
            return float("inf")
        return float(1.0 / lam2)

    def chi2(self) -> float:
        """Max effective-resistance term (Eq 3)."""
        Lp = np.linalg.pinv(self.laplacian())
        best = 0.0
        for (i, j) in self.edges:
            e = np.zeros(self.n)
            e[i], e[j] = 1.0, -1.0
            best = max(best, float(e @ Lp @ e))
        return 0.5 * best

    def is_connected(self) -> bool:
        lam = np.linalg.eigvalsh(self.laplacian())
        return bool(lam[1] > 1e-9)

    # ------------------------------------------------------------ matchings
    def edge_index(self) -> dict[Edge, int]:
        return {(min(i, j), max(i, j)): k for k, ((i, j)) in enumerate(self.edges)}

    def sample_matching(self, rng: np.random.Generator) -> list[Edge]:
        """Sample a maximal matching by scanning edges in random order.

        This emulates the paper's FIFO availability-queue pairing: every worker
        participates in at most one simultaneous p2p averaging, and edges are
        picked uniformly (App E.2 verifies uniformity holds in their runs).
        Edges with higher rate are proportionally more likely to be scanned
        first (weighted order), matching the expected Laplacian.
        """
        if not self.edges:  # e.g. a fully-churned phase
            return []
        order = rng.permutation(self.num_edges)
        w = np.asarray(self.rates, dtype=np.float64)
        if not np.allclose(w, w[0]):
            # weighted random order: Gumbel trick on log-rates
            keys = np.log(w) + rng.gumbel(size=self.num_edges)
            order = np.argsort(-keys)
        used = np.zeros(self.n, dtype=bool)
        matching: list[Edge] = []
        for k in order:
            i, j = self.edges[int(k)]
            if not (used[i] or used[j]):
                used[i] = used[j] = True
                matching.append((i, j))
        return matching

    def matching_to_partner(self, matching: Sequence[Edge]) -> np.ndarray:
        """partner[i] = j if (i,j) matched else i (self-loop = idle)."""
        p = np.arange(self.n)
        for (i, j) in matching:
            p[i], p[j] = j, i
        return p

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """JSON-ready description (the same dict the JAX package's World
        spec embeds)."""
        return {"n": self.n, "edges": [list(e) for e in self.edges],
                "rates": list(self.rates), "name": self.name}

    @staticmethod
    def from_dict(d: dict) -> "Graph":
        return Graph(int(d["n"]),
                     tuple((int(i), int(j)) for i, j in d["edges"]),
                     tuple(float(r) for r in d["rates"]),
                     name=d.get("name", "custom"))

    # ---------------------------------------------------------- derivations
    def with_rates(self, rates) -> "Graph":
        """Same topology with per-edge rates replaced (heterogeneous worlds:
        hot links, degraded links).  Rates align with ``self.edges``."""
        rates = tuple(float(r) for r in np.asarray(rates, dtype=np.float64))
        return Graph(self.n, self.edges, rates, name=self.name)

    def subgraph(self, active, relabel: bool = False) -> "Graph":
        """Induced subgraph on the ``active`` worker mask.

        relabel=False keeps all n worker slots (detached workers become
        isolated nodes — partner arrays stay n-wide, the scenario-engine
        form); relabel=True compacts to the active workers only (the form
        on which chi1/chi2 of a churned phase are well defined).
        """
        active = np.asarray(active, dtype=bool)
        if active.shape != (self.n,):
            raise ValueError(f"active mask must be ({self.n},)")
        keep = [(e, r) for e, r in zip(self.edges, self.rates)
                if active[e[0]] and active[e[1]]]
        edges = tuple(e for e, _ in keep)
        rates = tuple(r for _, r in keep)
        if not relabel:
            return Graph(self.n, edges, rates, name=f"{self.name}|churn")
        idx = np.cumsum(active) - 1  # old -> new labels
        edges = tuple((int(idx[i]), int(idx[j])) for (i, j) in edges)
        return Graph(int(active.sum()), edges, rates,
                     name=f"{self.name}|churn")


# ------------------------------------------------------------------ builders

def complete_graph(n: int, rate_per_worker: float = 1.0) -> Graph:
    """Complete graph; each worker communicates `rate_per_worker` times per unit
    time in expectation => each edge has rate rate_per_worker / (n-1)."""
    edges = tuple((i, j) for i in range(n) for j in range(i + 1, n))
    r = rate_per_worker / (n - 1)
    return Graph(n, edges, tuple(r for _ in edges), name="complete")


def ring_graph(n: int, rate_per_worker: float = 1.0) -> Graph:
    """Cycle graph; each worker has 2 neighbors => edge rate = rate/2."""
    edges = tuple((i, (i + 1) % n) for i in range(n)) if n > 2 else ((0, 1),)
    r = rate_per_worker / 2.0 if n > 2 else rate_per_worker
    return Graph(n, tuple((min(i, j), max(i, j)) for (i, j) in edges),
                 tuple(r for _ in edges), name="ring")


def exponential_graph(n: int, rate_per_worker: float = 1.0) -> Graph:
    """Exponential graph of [28, 2]: i connects to i +/- 2^k mod n."""
    edges = set()
    k = 0
    while (1 << k) < n:
        for i in range(n):
            j = (i + (1 << k)) % n
            if i != j:
                edges.add((min(i, j), max(i, j)))
        k += 1
    edges = tuple(sorted(edges))
    deg = np.zeros(n)
    for (i, j) in edges:
        deg[i] += 1
        deg[j] += 1
    # uniform edge rate chosen so the *average* worker rate matches
    r = rate_per_worker * n / (2 * len(edges))
    return Graph(n, edges, tuple(r for _ in edges), name="exponential")


def star_graph(n: int, rate_per_worker: float = 1.0) -> Graph:
    edges = tuple((0, i) for i in range(1, n))
    # center participates in every event; normalize so mean worker rate matches
    r = rate_per_worker * n / (2 * len(edges))
    return Graph(n, edges, tuple(r for _ in edges), name="star")


def torus_graph(side: int, rate_per_worker: float = 1.0) -> Graph:
    """2D torus (side x side) — the natural TPU-ICI-like topology (beyond paper)."""
    n = side * side
    edges = set()
    for r_ in range(side):
        for c in range(side):
            i = r_ * side + c
            for (dr, dc) in ((0, 1), (1, 0)):
                j = ((r_ + dr) % side) * side + (c + dc) % side
                if i != j:
                    edges.add((min(i, j), max(i, j)))
    edges = tuple(sorted(edges))
    r = rate_per_worker * n / (2 * len(edges))
    return Graph(n, edges, tuple(r for _ in edges), name="torus")


def hypercube_graph(dim: int, rate_per_worker: float = 1.0) -> Graph:
    """d-dimensional hypercube on n = 2^d workers (paper's well-connected
    family at n=64 alongside ring/torus); each worker has ``dim`` neighbors
    => edge rate = rate/dim."""
    n = 1 << dim
    edges = tuple(sorted((i, i ^ (1 << k)) for i in range(n)
                         for k in range(dim) if i < i ^ (1 << k)))
    r = rate_per_worker / dim
    return Graph(n, edges, tuple(r for _ in edges), name="hypercube")


_BUILDERS = {
    "complete": complete_graph,
    "ring": ring_graph,
    "exponential": exponential_graph,
    "star": star_graph,
}


def build_graph(name: str, n: int, rate_per_worker: float = 1.0) -> Graph:
    if name == "torus":
        side = int(round(n ** 0.5))
        if side * side != n:
            raise ValueError("torus needs a square worker count")
        return torus_graph(side, rate_per_worker)
    if name == "hypercube":
        dim = int(round(np.log2(n)))
        if (1 << dim) != n:
            raise ValueError("hypercube needs a power-of-two worker count")
        return hypercube_graph(dim, rate_per_worker)
    if name not in _BUILDERS:
        raise ValueError(f"unknown graph '{name}', have {sorted(_BUILDERS)}"
                         " + torus + hypercube")
    return _BUILDERS[name](n, rate_per_worker)


# -------------------------------------------------------- topology schedules

@dataclasses.dataclass(frozen=True)
class TopologyPhase:
    """One phase of a time-varying topology: a graph held for ``rounds``
    units of simulated time, with an optional churn mask detaching workers.

    ``active[i] = False`` detaches worker i for the whole phase: it joins no
    matchings, takes no gradient ticks, and its event clock freezes (the
    lazy-mixing ODE integrates over the full outage at its first event after
    rejoin — see DESIGN.md §8)."""

    graph: Graph
    rounds: int
    active: tuple[bool, ...] | None = None

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError("phase needs rounds >= 1")
        if self.active is not None and len(self.active) != self.graph.n:
            raise ValueError("active mask must have one entry per worker")

    def active_mask(self) -> np.ndarray:
        if self.active is None:
            return np.ones(self.graph.n, dtype=bool)
        return np.asarray(self.active, dtype=bool)

    def effective_graph(self) -> Graph:
        """The phase's communication graph with churned workers isolated
        (n-wide — what scheduling/matching banks consume)."""
        m = self.active_mask()
        return self.graph if m.all() else self.graph.subgraph(m)

    def chis(self) -> tuple[float, float]:
        """(chi1, chi2) of the phase, computed on the active workers only
        (isolated churned nodes would make the full-n chi1 infinite)."""
        g = self.graph.subgraph(self.active_mask(), relabel=True)
        return g.chi1(), g.chi2()

    def to_dict(self) -> dict:
        # bool() strips np.bool_ entries (tuple(np_mask) keeps them), which
        # the json encoder rejects
        return {"graph": self.graph.to_dict(), "rounds": int(self.rounds),
                "active": None if self.active is None
                else [bool(b) for b in self.active]}

    @staticmethod
    def from_dict(d: dict) -> "TopologyPhase":
        active = d.get("active")
        return TopologyPhase(Graph.from_dict(d["graph"]), int(d["rounds"]),
                             None if active is None
                             else tuple(bool(b) for b in active))


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A sequence of topology phases — ring->exponential switches, churn
    windows, degraded-link episodes.  The JAX package's
    ``events.make_topology_schedule`` compiles it into one concatenated
    event schedule; the port carries the data type only so far."""

    phases: tuple[TopologyPhase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("need at least one phase")
        ns = {p.graph.n for p in self.phases}
        if len(ns) != 1:
            raise ValueError(f"all phases must share one worker count, got {ns}")

    @property
    def n(self) -> int:
        return self.phases[0].graph.n

    @property
    def total_rounds(self) -> int:
        return sum(p.rounds for p in self.phases)

    def phase_starts(self) -> np.ndarray:
        """Start round of each phase (cumulative durations, leading 0)."""
        return np.concatenate(
            [[0], np.cumsum([p.rounds for p in self.phases])[:-1]]).astype(int)

    def phase_at(self, rnd: int) -> int:
        """Index of the phase covering simulated round ``rnd``."""
        if not (0 <= rnd < self.total_rounds):
            raise ValueError(f"round {rnd} outside [0, {self.total_rounds})")
        return int(np.searchsorted(self.phase_starts(), rnd, side="right") - 1)

    def phase_chis(self) -> list[tuple[float, float]]:
        return [p.chis() for p in self.phases]

    def to_dict(self) -> dict:
        return {"phases": [p.to_dict() for p in self.phases]}

    @staticmethod
    def from_dict(d: dict) -> "TopologySchedule":
        return TopologySchedule(tuple(TopologyPhase.from_dict(p)
                                      for p in d["phases"]))
