"""SPMD gossip on one card: the paper's p2p averaging across a worker axis.

In the JAX package a decentralized *worker* is one slice of a device mesh
along a "worker" axis, and a pairwise averaging event between workers i and
j is a ``jax.lax.ppermute`` along that axis: every chip sends its parameter
shard to its partner and runs the fused event kernel on its own vectors.
The step is a per-worker program with collectives in it (``ppermute``,
``axis_index``, ``pmean``, ``psum``).

Here one process drives all W workers in lockstep on one card, through a
``WorkerAxis``.  Its ``ppermute`` hands each worker a reference to its
partner's tensor: on one card an exchange moves no bytes, so what this path
measures is the per-worker kernels and gradients, not an interconnect.
Each worker still runs its own fused pass on its own (D,) vectors (one
``p2p_mixing`` launch per worker and event, idle and dropped workers
included), which is the per-chip work of the TPU path.  Threads as ranks
were not taken: one rank that raises leaves the others waiting at a
barrier, and the launch order would change from run to run.  Processes
cannot exchange CUDA tensors point to point on one card.

``ppermute`` needs a *static* permutation, while the algorithm samples
random matchings.  The edge set is therefore decomposed into a static
*matching bank* by greedy edge coloring (every color class is a matching;
by Vizing's theorem at most max_degree+1 classes), and each event picks a
bank entry.  Sampling bank entries uniformly realizes uniform edge
frequencies, the assumption under which chi1/chi2 are computed (paper App
E.2).  The coloring is the one ``networkx.greedy_color(line_graph(G),
"largest_first")`` gives, rebuilt step for step without networkx, so the
banks equal the JAX package's exactly.

Random draws are shared: the matching indices, the event gaps, the drops
and the staleness offsets are one host draw that every worker reads; only
each worker's gradient clock is its own.  ``gossip_events`` takes the
draws as arguments (draw, then apply).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .a2cid2 import A2CiD2Params, apply_mixing
from .channel import ChannelModel
from .engine import FlatGossipEngine
from .graphs import Graph, TopologySchedule
from .tree import PyTree, tree_leaves, tree_map


def bank_corruption(bank: np.ndarray, adversary) -> np.ndarray:
    """Per-matching received-value corruption offsets for a static bank.

    Returns (M, n) float32: entry [k, i] is the multiplier offset worker i
    applies to the value it receives under matching k (0 = honest).  The
    Byzantine edge set is STATIC, so mesh trainers resolve the channel's
    ``corrupt`` axis to one constant vector per bank entry, exactly like
    the matchings themselves.
    """
    M, n = bank.shape
    out = np.zeros((M, n), np.float32)
    if adversary is None:
        return out
    byz = adversary.lookup(n)
    off = np.float32(adversary.corrupt_offset())
    for k in range(M):
        for i in range(n):
            j = int(bank[k, i])
            if j != i and byz[i, j]:
                out[k, i] = off
    return out


def check_mesh_channel(channel: ChannelModel | None,
                       permute_ring: bool = False) -> None:
    """Mesh trainers model the statically resolvable channel axes
    (always-on adversary, drops) plus, when the trainer carries the
    bounded-staleness ring (``permute_ring=True``), message delay: each
    worker keeps a ring of its OWN past flat states and resolves a read's
    staleness before the permute ships it.  Only the ``DelayProcess`` kinds
    the ring can sample ("uniform", "fixed") are routed; an unknown kind, or
    any delay on a ring-less trainer, is rejected.  A duty-cycled adversary
    (prob < 1) stays rejected either way: it needs pair-correlated
    corruption draws the per-worker event loop cannot share."""
    if channel is None:
        return
    if not isinstance(channel, ChannelModel):
        raise ValueError("channel must be a ChannelModel, "
                         f"got {type(channel).__name__}")
    if channel.horizon > 0:
        if not permute_ring:
            raise ValueError(
                "this mesh trainer does not emulate message delay (stale "
                "partner reads need a ring buffer of past states) — "
                "replay delayed worlds with Simulator.run_world, use a "
                "permute-ring trainer, or drop the DelayProcess from the "
                "trainer's channel")
        if channel.delay.kind not in ("uniform", "fixed"):
            raise ValueError(
                "the bounded-staleness permute ring samples 'uniform' "
                "and 'fixed' DelayProcess kinds only, got "
                f"{channel.delay.kind!r} — replay this delay law with "
                "Simulator.run_world")
    if channel.adversary is not None and channel.adversary.prob < 1.0:
        raise ValueError(
            "mesh trainers model always-on Byzantine edges only (a "
            "prob < 1 duty cycle needs per-exchange corruption draws "
            "shared across the pair) — replay duty-cycled adversaries "
            "with Simulator.run_world, or set ByzantineEdges.prob = 1")


# --------------------------------------------------------- matching banks

def _line_graph(n: int, edges) -> dict:
    """The line graph of the graph on nodes 0..n-1 with ``edges``, as
    ``networkx.line_graph`` builds it: {node: set of neighbours}, its keys
    in networkx's node order.

    That order decides the coloring's ties, and networkx takes it from the
    iteration order of a Python ``set`` of node pairs, so the set is built
    here with the same insertions in the same order (tuples of ints hash
    the same in every process).  A node's edges come in the order its
    neighbours were first added; an edge is the sorted pair.
    """
    adj: list[dict] = [{} for _ in range(n)]
    for u, v in edges:
        adj[int(u)][int(v)] = None
        adj[int(v)][int(u)] = None
    lg: dict = {}
    pairs: set = set()
    for u in range(n):
        nodes = [tuple(sorted((u, v))) for v in adj[u]]
        if len(nodes) == 1:
            lg.setdefault(nodes[0], set())
        for i, a in enumerate(nodes):
            pairs.update([tuple(sorted((a, b))) for b in nodes[i + 1:]])
    for a, b in pairs:
        lg.setdefault(a, set()).add(b)
        lg.setdefault(b, set()).add(a)
    return lg


def matching_bank(graph: Graph) -> np.ndarray:
    """Decompose edges into matchings via greedy edge coloring.

    Returns (M, n) int32: bank[k, i] = partner of worker i in matching k
    (i itself if idle).  Union over k covers every edge exactly once.  An
    edgeless graph (e.g. a fully churned phase) yields one identity row.
    The coloring is networkx's "largest_first" greedy coloring of the line
    graph: nodes by degree, descending, ties in node order (a stable sort),
    each taking the smallest color no neighbour holds.
    """
    if not graph.edges:
        return np.arange(graph.n, dtype=np.int32)[None, :]
    lg = _line_graph(graph.n, graph.edges)
    colors: dict = {}
    for u in sorted(lg, key=lambda v: len(lg[v]), reverse=True):
        used = {colors[v] for v in lg[u] if v in colors}
        colors[u] = next(c for c in range(len(used) + 1) if c not in used)
    bank = np.tile(np.arange(graph.n, dtype=np.int32),
                   (max(colors.values()) + 1, 1))
    for (i, j), color in colors.items():
        bank[color, i] = j
        bank[color, j] = i
    return bank


def bank_edge_rates(graph: Graph, bank: np.ndarray) -> np.ndarray:
    """Per-matching sampling weights reproducing the graph's edge rates.

    For uniform-rate graphs this is uniform over the bank.  For non-uniform
    rates each matching is weighted by the mean rate of its edges
    (approximate; exact per-edge rates would need non-maximal matchings).
    """
    rates = {tuple(sorted(e)): r for e, r in zip(graph.edges, graph.rates)}
    w = np.zeros(bank.shape[0])
    for k in range(bank.shape[0]):
        edge_rs = [rates[(i, int(j))] for i, j in enumerate(bank[k])
                   if int(j) > i]
        w[k] = float(np.mean(edge_rs)) if edge_rs else 0.0
    s = w.sum()
    return w / s if s > 0 else np.full(bank.shape[0], 1.0 / bank.shape[0])


def phase_banks(tsched: TopologySchedule
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-phase (matching bank, sampling probs) for a time-varying
    topology.  Each phase's bank comes from its *effective* graph (churned
    workers isolated: their rows are identity in every matching)."""
    out = []
    for ph in tsched.phases:
        g = ph.effective_graph()
        bank = matching_bank(g)
        out.append((bank, bank_edge_rates(g, bank)))
    return out


def world_banks(world, rounds: int | None = None, seed: int = 0
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-segment (matching bank, sampling probs) for a declarative World:
    segments from ``World.segment_graphs`` (link-model rates applied,
    churned workers isolated), one-to-one with the compiled schedule's
    phases under the same (rounds, seed)."""
    out = []
    for g in world.segment_graphs(rounds, seed):
        bank = matching_bank(g)
        out.append((bank, bank_edge_rates(g, bank)))
    return out


# ------------------------------------------------------ shared host draws

def stale_draws(delay, generator: torch.Generator, shape: tuple
                ) -> torch.Tensor:
    """int32 raw staleness draws of ``shape`` from a DelayProcess law (0 =
    fresh): stale with probability ``delay.prob``, by ``horizon`` rounds
    ("fixed") or by a uniform 1..horizon."""
    hit = torch.rand(shape, generator=generator) < delay.prob
    if delay.kind == "fixed":
        offs = torch.full(shape, delay.horizon, dtype=torch.int32)
    else:
        offs = torch.randint(1, delay.horizon + 1, shape,
                             generator=generator, dtype=torch.int32)
    return torch.where(hit, offs, 0).to(torch.int32)


def matching_draws(probs, generator: torch.Generator, num_events: int
                   ) -> torch.Tensor:
    """(E,) int32 bank indices drawn with the bank's sampling ``probs``."""
    if not num_events:
        return torch.zeros(0, dtype=torch.int32)
    return torch.multinomial(torch.as_tensor(probs), num_events,
                             replacement=True,
                             generator=generator).to(torch.int32)


def drop_draws(idxs: torch.Tensor, generator: torch.Generator,
               drop_prob: float) -> torch.Tensor:
    """``idxs`` with each event dropped (-1) with probability
    ``drop_prob``; draws nothing when it is 0."""
    if drop_prob <= 0.0:
        return idxs
    dropped = torch.rand(idxs.shape[0], generator=generator) < drop_prob
    return torch.where(dropped, -1, idxs).to(torch.int32)


# --------------------------------------------------------- the worker axis

@dataclasses.dataclass(frozen=True)
class WorkerAxis:
    """The mesh's worker axis with all W workers in one process.

    A per-worker value is a list indexed by worker; the collectives take
    and return such lists (or, for the reductions, one value every worker
    shares).  Nothing is copied: ``ppermute`` hands out references.
    """

    n: int

    def index(self) -> range:
        """The worker indices, the counterpart of ``axis_index``."""
        return range(self.n)

    def ppermute(self, values: Sequence, perm) -> list:
        """``jax.lax.ppermute``: ``perm`` holds (source, destination) pairs;
        a worker that is no destination receives zeros."""
        out: list = [None] * self.n
        for src, dst in perm:
            out[dst] = values[src]
        return [torch.zeros_like(values[w]) if v is None else v
                for w, v in enumerate(out)]

    def psum(self, values: Sequence[PyTree]) -> PyTree:
        """Leafwise sum over the workers' pytrees."""
        return tree_map(lambda *ls: torch.stack(ls).sum(0), values[0],
                        *values[1:])

    def pmean(self, values: Sequence[PyTree]) -> PyTree:
        """Leafwise mean over the workers' pytrees (``psum / n``)."""
        return tree_map(lambda s: s / self.n, self.psum(values))


class DelayRing(NamedTuple):
    """A bounded-staleness ring: ``buf`` holds the last H flat snapshots
    ((H, D) for one worker of the SPMD trainer, (H, W, D) for the stacked
    trainer; slot = round % H), ``round`` the index of the last pushed round
    (-1 before the first push), kept on the host.  The ring owns its
    storage and a push writes a slot in place."""

    buf: torch.Tensor
    round: int


class GossipMixer:
    """Applies A2CiD2 events across the worker axis, all workers in
    lockstep: per-worker values are lists indexed by worker."""

    def __init__(self, graph: Graph, params: A2CiD2Params,
                 channel: ChannelModel | None = None,
                 robust_clip: float | None = None,
                 robust_rule: str = "trim"):
        check_mesh_channel(channel, permute_ring=True)
        self.graph = graph
        self.params = params
        self.axis = WorkerAxis(graph.n)
        self.bank = matching_bank(graph)
        self.bank_probs = bank_edge_rates(graph, self.bank)
        # unreliable-channel axes a mesh can model: static Byzantine edges
        # become per-matching corruption vectors, drops thin the sampled
        # event stream, robust_clip/robust_rule engage the robust m-term
        self.channel = channel
        self.robust_clip = robust_clip
        self.robust_rule = robust_rule
        self.drop_prob = 0.0 if channel is None else channel.drop_prob
        self.bank_corrupt = bank_corruption(
            self.bank, None if channel is None else channel.adversary)
        # message delay rides the ring; trivial delay lowers to None
        d = None if channel is None else channel.delay
        self.delay = None if d is None or d.is_trivial else d

    def _engine(self, x: PyTree) -> FlatGossipEngine:
        return FlatGossipEngine.for_pytree(x, self.params, stacked=False,
                                           robust_clip=self.robust_clip,
                                           robust_rule=self.robust_rule)

    # ------------------------------------------------- delay (permute ring)
    def init_ring(self, xs: Sequence[PyTree]) -> list[DelayRing] | None:
        """A fresh ring for each worker's replica (None without delay)."""
        if self.delay is None:
            return None
        engine = self._engine(xs[0])
        return [DelayRing(engine.pack_local(x).unsqueeze(0).repeat(
            self.delay.horizon, 1), -1) for x in xs]

    def push_ring(self, rings: list[DelayRing] | None,
                  xs: Sequence[PyTree]) -> list[DelayRing] | None:
        """Snapshot each worker's replica at its gradient tick (the
        simulator's ring cadence), in place."""
        if rings is None:
            return None
        engine = self._engine(xs[0])
        out = []
        for ring, x in zip(rings, xs):
            r = ring.round + 1
            ring.buf[r % self.delay.horizon].copy_(engine.pack_local(x))
            out.append(DelayRing(ring.buf, r))
        return out

    def sample_stale(self, generator: torch.Generator, num_events: int
                     ) -> torch.Tensor:
        """(E,) int32 raw staleness draws from the channel's DelayProcess
        law (0 = fresh), shared by all workers; ``gossip_events`` clamps
        them to the rounds actually pushed."""
        return stale_draws(self.delay, generator, (num_events,))

    # ------------------------------------------------------------ primitives
    def _perm(self, k: int) -> list[tuple[int, int]]:
        return [(i, int(j)) for i, j in enumerate(self.bank[k])]

    def mix(self, xs: Sequence[PyTree], xts: Sequence[PyTree],
            dts: torch.Tensor) -> tuple[list, list]:
        """Lazy continuous mixing exp(dt*A) of each worker's pair, for its
        own elapsed time ``dts[w]``."""
        out = [apply_mixing(x, xt, self.params.eta, dts[w])
               for w, (x, xt) in enumerate(zip(xs, xts))]
        return [o[0] for o in out], [o[1] for o in out]

    def gossip_events(self, xs: Sequence[PyTree], xts: Sequence[PyTree],
                      matching_idxs, dts: torch.Tensor, *,
                      rings: list[DelayRing] | None = None,
                      stale=None) -> tuple[list, list]:
        """Apply a fixed-length sequence of (mix, p2p) events.

        matching_idxs (E,) int host values: bank index per event (negative
        = skip, a dropped message); dts (E,) f32: the elapsed time before
        each event, shared by all workers (moved to the replicas' device
        once, then read by the kernels through pointers).  rings/stale:
        bounded-staleness delay; ``stale`` (E,) int host draws
        (``sample_stale``), each worker resolving its outgoing value against
        its own ring before the permute.

        The event loop runs on the flat-buffer engine: each replica is
        packed ONCE into a (D,) vector, each event is one permute plus one
        fused [p2p, mix-to-next-event] launch per worker, and the pytrees
        are rebuilt once at the end.  The regrouping

            mix(dt_0), P_0, mix(dt_1), P_1, ... =
            [mix(dt_0)] [P_0, mix(dt_1)] ... [P_{E-1}, mix(0)]

        is exact (semigroup property), so the dynamic is unchanged.
        """
        idxs = [int(i) for i in matching_idxs]
        if not idxs:
            return list(xs), list(xts)
        axis, n = self.axis, self.axis.n
        engine = self._engine(xs[0])
        dev = tree_leaves(xs[0])[0].device
        dts = torch.as_tensor(dts, dtype=torch.float32).to(dev)
        bx = [engine.pack_local(x) for x in xs]
        bxt = [engine.pack_local(x) for x in xts]
        for w in axis.index():
            bx[w], bxt[w] = engine.mix(bx[w], bxt[w], dts[0])
        dt_next = torch.cat([dts[1:], dts.new_zeros(1)])
        channel_on = (self.robust_clip is not None
                      or bool(self.bank_corrupt.any()))
        m = self.bank.shape[0]
        if channel_on:
            # one more row of zeros: a skipped event reads honestly
            corrupt_tab = torch.as_tensor(np.concatenate(
                [self.bank_corrupt, np.zeros((1, n), np.float32)]),
                device=dev)
        delayed = self.delay is not None and rings is not None \
            and stale is not None
        if delayed:
            stale = [int(s) for s in stale]
            h = self.delay.horizon
        for e, idx in enumerate(idxs):
            k = max(idx, 0)
            payload = bx
            if delayed:
                # clamp to the rounds pushed, resolve against each worker's
                # OWN ring; an idle worker receives its own payload back,
                # which stays fresh so an idle event is an exact no-op
                payload = []
                for w in axis.index():
                    r = rings[w].round
                    s = min(stale[e], max(r, 0)) \
                        if self.bank[k, w] != w else 0
                    payload.append(rings[w].buf[(r - s) % h] if s > 0
                                   else bx[w])
            xp = axis.ppermute(payload, self._perm(k))
            if idx < 0:
                # a skipped event keeps the pure-mix segment: xp = x, m = 0
                xp = bx
            dtn = dt_next[e]
            new = []
            for w in axis.index():
                if channel_on:
                    c = corrupt_tab[m if idx < 0 else k, w]
                    new.append(engine.channel_batch_local(
                        bx[w], bxt[w], xp[w], c, dtn))
                else:
                    new.append(engine.batch_local(bx[w], bxt[w], xp[w],
                                                  dtn))
            bx = [o[0] for o in new]
            bxt = [o[1] for o in new]
        return ([engine.unpack_local(v) for v in bx],
                [engine.unpack_local(v) for v in bxt])

    # ------------------------------------------------------------ schedules
    def sample_event_batch(self, generator: torch.Generator,
                           num_events: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """One super-step's shared (matching_idxs, gaps) on the host.

        ``num_events`` always-active slots at the expected rate (the slot
        count is the host's, like the paper's implementation); matchings are
        drawn with the bank's edge-rate weights, gaps are Exp(1)/num_events,
        and a dropped message (channel drops) becomes a skip (idx -1) whose
        simulated time still elapses.
        """
        idxs = matching_draws(self.bank_probs, generator, num_events)
        gaps = torch.empty(num_events).exponential_(generator=generator) \
            / max(num_events, 1)
        return drop_draws(idxs, generator, self.drop_prob), gaps


def consensus_distance_spmd(xs: Sequence[PyTree]) -> torch.Tensor:
    """||pi x||^2 / n across the worker axis: the workers' mean squared
    distance to their mean."""
    axis = WorkerAxis(len(xs))

    def leaf(ls):
        mean = axis.pmean(list(ls))
        return axis.psum([((a - mean) ** 2).sum() for a in ls]) / axis.n

    return sum(leaf(ls) for ls in zip(*(tree_leaves(x) for x in xs)))
