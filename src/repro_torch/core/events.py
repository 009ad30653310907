"""Poisson event schedules for the asynchronous dynamic (Assumption 3.2).

The paper's implementation emulates the point processes: "each worker samples
a random number of p2p averagings to perform between each gradient
computation, following a Poisson law using the communication rate as mean",
and pairs available workers through a FIFO queue (~ uniform matchings,
App E.2).  This module reproduces exactly that emulation:

  * a *round* covers one unit of simulated time; every worker takes one
    gradient step per round at a jittered time,
  * the number of matching events in a round is Poisson(comm_rate) — a
    matching event pairs (at most) all workers simultaneously,
  * matchings are maximal matchings sampled from random edge orders.

Schedules are host-side numpy data.  This is the subset of
``repro.core.events`` that the replays need (raw schedules, topology
schedules, coalescing, the flattened event stream, and the many-worlds
batching of schedules and streams); every array it returns is equal, array
for array, to the JAX package's for the same arguments and seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graphs import Graph, TopologySchedule


def _alive_arr(rounds: int, n: int, alive: np.ndarray | None) -> np.ndarray:
    """(R, n) bool aliveness, materialized (None = all alive)."""
    if alive is None:
        return np.ones((rounds, n), dtype=bool)
    return np.asarray(alive, dtype=bool)


def _grad_scale(rounds: int, n: int, grad_mask: np.ndarray | None,
                alive: np.ndarray | None) -> np.ndarray:
    """(R, n) f32 gradient-application scale: 1.0 iff the worker both takes
    the tick (grad_mask) and is attached (alive)."""
    s = np.ones((rounds, n), dtype=bool)
    if grad_mask is not None:
        s &= np.asarray(grad_mask, dtype=bool)
    s &= _alive_arr(rounds, n, alive)
    return s.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed event schedule for `rounds` units of simulated time.

    Shapes (R = rounds, K = max events/round, n = workers):
      partners    (R, K, n) int32 — partner[e, i] = j or i (idle / masked)
      event_times (R, K) float32  — sorted within each round, masked events
                                    repeat the previous valid time
      event_mask  (R, K) bool
      grad_times  (R, n) float32  — time of each worker's gradient event
      grad_mask   (R, n) bool or None — straggler thinning (alive, no grad)
      alive       (R, n) bool or None — churn (detached, clock frozen)
      extras      dict of named (R, K, n) per-event arrays or None — the
                  unreliable-channel keys ("stale", "corrupt") live here
                  (``channel.ChannelModel.apply`` attaches them with
                  ``with_extras``; the channel replays consume them)
    """

    partners: np.ndarray
    event_times: np.ndarray
    event_mask: np.ndarray
    grad_times: np.ndarray
    grad_mask: np.ndarray | None = None
    alive: np.ndarray | None = None
    extras: dict[str, np.ndarray] | None = None

    @property
    def rounds(self) -> int:
        return self.partners.shape[0]

    @property
    def n(self) -> int:
        return self.partners.shape[2]

    def alive_arr(self) -> np.ndarray:
        return _alive_arr(self.rounds, self.n, self.alive)

    def grad_scale(self) -> np.ndarray:
        return _grad_scale(self.rounds, self.n, self.grad_mask, self.alive)

    def extras_dict(self) -> dict[str, np.ndarray]:
        return dict(self.extras) if self.extras else {}

    def with_extras(self, **arrays: np.ndarray) -> "Schedule":
        """Attach named per-event attribute arrays (merged with existing).

        Each array must be (R, K, n) — per event, per worker — or (R, K)
        (a per-event scalar, broadcast across workers here so downstream
        compilation stages handle one shape).
        """
        R, K, n = self.partners.shape
        out = self.extras_dict()
        for name, a in arrays.items():
            a = np.asarray(a)
            if a.shape == (R, K):
                a = np.broadcast_to(a[:, :, None], (R, K, n)).copy()
            if a.shape != (R, K, n):
                raise ValueError(
                    f"extras[{name!r}] must have shape ({R}, {K}, {n}) = "
                    f"(rounds, kmax, n) or ({R}, {K}), got {a.shape}")
            out[name] = a
        return dataclasses.replace(self, extras=out)

    def with_grad_gate(self, gate: np.ndarray) -> "Schedule":
        """AND a (R, n) boolean gate into ``grad_mask``: a False entry skips
        that worker's round-r gradient tick like straggler thinning (the
        worker stays alive, its clock advances, mixing applies)."""
        gate = np.asarray(gate, dtype=bool)
        if gate.shape != (self.rounds, self.n):
            raise ValueError(
                f"grad gate must have shape ({self.rounds}, {self.n}) = "
                f"(rounds, n), got {gate.shape}")
        mask = gate if self.grad_mask is None else (self.grad_mask & gate)
        return dataclasses.replace(self, grad_mask=mask)

    def comm_events_per_round(self) -> np.ndarray:
        """(R,) pairwise communication count per round (benchmark x-axis)."""
        idx = np.arange(self.n)
        out = np.zeros(self.rounds, dtype=np.int64)
        for r in range(self.rounds):
            for k in range(self.partners.shape[1]):
                if self.event_mask[r, k]:
                    out[r] += int(np.sum(self.partners[r, k] != idx)) // 2
        return out

    def num_comm_events(self) -> int:
        """Total pairwise communications in the schedule (counted per
        pair)."""
        return int(self.comm_events_per_round().sum())


def make_schedule(
    graph: Graph,
    rounds: int,
    comms_per_grad: float = 1.0,
    seed: int = 0,
    jitter_grad_times: bool = True,
    grad_rates: np.ndarray | None = None,
    edge_rates: np.ndarray | None = None,
    per_edge: bool | None = None,
    t_offset: float = 0.0,
    active: np.ndarray | None = None,
) -> Schedule:
    """Build a Poisson event schedule, homogeneous or heterogeneous.

    The JAX package routes these kwargs through its declarative World
    compiler; for a static graph that compiler makes exactly one call to
    the raw sampler with the same arguments, so calling the sampler
    directly gives the identical schedule under the same seed.

    comms_per_grad — expected number of p2p averagings per worker between two
      of its gradient steps (the paper's "#com/#grad" knob, Tab 5).
    grad_rates — (n,) per-worker gradient rates in [0, 1] (straggler
      Bernoulli thinning of the unit-rate tick process).
    edge_rates — (E,) per-edge rates overriding ``graph.rates``; non-uniform
      rates switch to the per-edge point process of Def 3.1.
    per_edge — force the per-edge path on/off (None = auto as above).
    t_offset — shift all event/gradient times.
    active — (n,) churn mask: detached workers join no matchings and are
      marked dead for every round.
    """
    return _sample_schedule(graph, rounds, comms_per_grad, seed=seed,
                            jitter_grad_times=jitter_grad_times,
                            grad_rates=grad_rates, edge_rates=edge_rates,
                            per_edge=per_edge, t_offset=t_offset,
                            active=active)


def _sample_schedule(
    graph: Graph,
    rounds: int,
    comms_per_grad: float = 1.0,
    seed: int = 0,
    jitter_grad_times: bool = True,
    grad_rates: np.ndarray | None = None,
    edge_rates: np.ndarray | None = None,
    per_edge: bool | None = None,
    t_offset: float = 0.0,
    active: np.ndarray | None = None,
) -> Schedule:
    """The raw Poisson sampler (byte-stable copy of the JAX package's)."""
    rng = np.random.default_rng(seed)
    # heterogeneity draws come from an independent stream so that uniform
    # rates leave the main stream — and hence the schedule — untouched
    het = np.random.default_rng(np.random.SeedSequence([int(seed), 0x48455]))
    n = graph.n

    # rate override first (edge_rates align with the FULL graph's edges),
    # churn subgraph second (it filters rates along with edges)
    if edge_rates is not None:
        edge_rates = np.asarray(edge_rates, dtype=np.float64)
        if per_edge is None:
            per_edge = not np.allclose(edge_rates, graph.rates)
        graph = graph.with_rates(edge_rates)
    elif per_edge is None:
        per_edge = False
    if active is not None:
        active = np.asarray(active, dtype=bool)
        if not active.all():
            graph = graph.subgraph(active)

    if per_edge:
        partners, event_times, event_mask = _per_edge_events(
            graph, rounds, comms_per_grad, rng, t_offset)
        kmax = partners.shape[1]
    else:
        counts = rng.poisson(lam=comms_per_grad, size=rounds)
        kmax = max(1, int(counts.max()))
        partners = np.tile(np.arange(n, dtype=np.int32), (rounds, kmax, 1))
        event_times = np.zeros((rounds, kmax), dtype=np.float32)
        event_mask = np.zeros((rounds, kmax), dtype=bool)
        for r in range(rounds):
            k = int(counts[r])
            times = np.sort(rng.uniform(r + t_offset, r + t_offset + 1,
                                        size=k)).astype(np.float32)
            last = np.float32(r + t_offset)
            for e in range(kmax):
                if e < k:
                    matching = graph.sample_matching(rng)
                    partners[r, e] = graph.matching_to_partner(
                        matching).astype(np.int32)
                    event_times[r, e] = times[e]
                    event_mask[r, e] = True
                    last = times[e]
                else:
                    # masked: dt contribution handled by mask
                    event_times[r, e] = last

    grad_times = np.zeros((rounds, n), dtype=np.float32)
    for r in range(rounds):
        if jitter_grad_times:
            # each worker's gradient lands at a jittered point in the second
            # half of the round (unit-rate process, staggered workers)
            grad_times[r] = (r + t_offset + 0.5
                             + 0.5 * rng.uniform(size=n)).astype(np.float32)
        else:
            grad_times[r] = np.float32(r + t_offset + 1.0)
        # gradient events must come after the last comm event of the round
        grad_times[r] = np.maximum(grad_times[r],
                                   event_times[r].max() + 1e-4)

    grad_mask = None
    if grad_rates is not None:
        gr = np.clip(np.asarray(grad_rates, dtype=np.float64), 0.0, 1.0)
        if gr.shape != (n,):
            raise ValueError(f"grad_rates must be ({n},), got {gr.shape}")
        grad_mask = het.uniform(size=(rounds, n)) < gr
    alive = None
    if active is not None and not active.all():
        alive = np.broadcast_to(active, (rounds, n)).copy()

    return Schedule(partners, event_times, event_mask, grad_times,
                    grad_mask=grad_mask, alive=alive)


def _per_edge_events(graph: Graph, rounds: int, comms_per_grad: float,
                     rng: np.random.Generator, t_offset: float):
    """Per-edge Poisson firing (Def 3.1): edge e fires Poisson(c * rate_e)
    times per round; each firing is a single-pair event."""
    n, E = graph.n, graph.num_edges
    lam = comms_per_grad * np.asarray(graph.rates, dtype=np.float64)
    counts = rng.poisson(lam=lam, size=(rounds, max(E, 1))) if E else \
        np.zeros((rounds, 1), dtype=np.int64)
    kmax = max(1, int(counts.sum(axis=1).max()))
    partners = np.tile(np.arange(n, dtype=np.int32), (rounds, kmax, 1))
    event_times = np.zeros((rounds, kmax), dtype=np.float32)
    event_mask = np.zeros((rounds, kmax), dtype=bool)
    for r in range(rounds):
        fired = np.repeat(np.arange(counts.shape[1]), counts[r]) if E else \
            np.zeros(0, np.int64)
        k = len(fired)
        rng.shuffle(fired)  # decorrelate edge identity from the sorted times
        times = np.sort(rng.uniform(r + t_offset, r + t_offset + 1,
                                    size=k)).astype(np.float32)
        last = np.float32(r + t_offset)
        for e in range(kmax):
            if e < k:
                i, j = graph.edges[int(fired[e])]
                partners[r, e, i] = j
                partners[r, e, j] = i
                event_times[r, e] = times[e]
                event_mask[r, e] = True
                last = times[e]
            else:
                event_times[r, e] = last
    return partners, event_times, event_mask


def concat_schedules(schedules: list[Schedule]) -> Schedule:
    """Concatenate per-phase schedules (absolute times) into one Schedule.

    Rounds are padded to the widest per-phase kmax with masked
    identity-partner slots, so the replay consumes the result exactly like
    a single-phase schedule.
    """
    if not schedules:
        raise ValueError("need at least one schedule")
    if len(schedules) == 1:
        return schedules[0]
    n = schedules[0].n
    if any(s.n != n for s in schedules):
        raise ValueError("schedules must share one worker count")
    kmax = max(s.partners.shape[1] for s in schedules)
    parts, times, masks = [], [], []
    for s in schedules:
        R, K, _ = s.partners.shape
        if K < kmax:
            pad_p = np.tile(np.arange(n, dtype=np.int32), (R, kmax - K, 1))
            # masked pads repeat the row's last time (dt handled by mask)
            pad_t = np.repeat(s.event_times[:, -1:], kmax - K, axis=1)
            parts.append(np.concatenate([s.partners, pad_p], axis=1))
            times.append(np.concatenate([s.event_times, pad_t], axis=1))
            masks.append(np.concatenate(
                [s.event_mask, np.zeros((R, kmax - K), bool)], axis=1))
        else:
            parts.append(s.partners)
            times.append(s.event_times)
            masks.append(s.event_mask)
    any_gmask = any(s.grad_mask is not None for s in schedules)
    any_alive = any(s.alive is not None for s in schedules)
    gmask = np.concatenate(
        [s.grad_mask if s.grad_mask is not None
         else np.ones((s.rounds, n), bool) for s in schedules]) \
        if any_gmask else None
    alive = np.concatenate([s.alive_arr() for s in schedules]) \
        if any_alive else None
    # extension channel: union of keys; schedules without a key contribute
    # zero rows, the K axis pads with zeros like masked slots
    keys: list[str] = []
    for s in schedules:
        keys += [k for k in s.extras_dict() if k not in keys]
    extras = None
    if keys:
        extras = {}
        for k in keys:
            dtype = next(s.extras[k].dtype for s in schedules
                         if s.extras_dict().get(k) is not None)
            chunks = []
            for s in schedules:
                a = s.extras_dict().get(k)
                if a is None:
                    a = np.zeros((s.rounds, kmax, n), dtype)
                elif a.shape[1] < kmax:
                    a = np.concatenate(
                        [a, np.zeros((s.rounds, kmax - a.shape[1], n),
                                     a.dtype)], axis=1)
                chunks.append(a)
            extras[k] = np.concatenate(chunks)
    return Schedule(
        np.concatenate(parts), np.concatenate(times).astype(np.float32),
        np.concatenate(masks),
        np.concatenate([s.grad_times for s in schedules]).astype(np.float32),
        grad_mask=gmask, alive=alive, extras=extras)


def make_topology_schedule(
    tsched: TopologySchedule,
    comms_per_grad: float = 1.0,
    seed: int = 0,
    jitter_grad_times: bool = True,
    grad_rates: np.ndarray | None = None,
    per_edge: bool | None = None,
) -> Schedule:
    """Compile a time-varying topology into one concatenated schedule,
    through ``World``: phase p covers its own rounds with its own graph and
    churn mask, sampled with seed ``seed + p``, so a single-phase topology
    schedule reproduces ``make_schedule(graph, ..., seed)`` bit for bit."""
    from .world import LinkModel, WorkerModel, World

    world = World(topology=tsched,
                  workers=WorkerModel(grad_rates=grad_rates),
                  links=LinkModel(per_edge=per_edge),
                  comms_per_grad=comms_per_grad,
                  jitter_grad_times=jitter_grad_times)
    return world.compile(seed=seed)


# ---------------------------------------------------------------------------
# Event coalescing (flat-buffer event engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoalescedSchedule:
    """Schedule compiled to fused event *batches* (B = max batches/round).

    A batch is a set of events whose matchings are worker-disjoint, so their
    updates commute and apply in ONE sweep of the state with a combined
    partner involution and per-worker event times.  Masked slots vanish.

    Shapes (R = rounds, B = max batches/round, n = workers):
      partners     (R, B, n) int32 — combined involution; i for idle workers
      wtimes       (R, B, n) f32   — per-worker event time (valid where the
                                     worker is involved, i.e. partner != i)
      batch_active (R, B) bool     — False = padding, skip the sweep
      grad_times   (R, n) f32      — unchanged from the raw schedule
      grad_mask / alive / extras   — carried through from the raw schedule
    """

    partners: np.ndarray
    wtimes: np.ndarray
    batch_active: np.ndarray
    grad_times: np.ndarray
    grad_mask: np.ndarray | None = None
    alive: np.ndarray | None = None
    extras: dict[str, np.ndarray] | None = None

    @property
    def rounds(self) -> int:
        return self.partners.shape[0]

    @property
    def n(self) -> int:
        return self.partners.shape[2]

    def alive_arr(self) -> np.ndarray:
        return _alive_arr(self.rounds, self.n, self.alive)

    def grad_scale(self) -> np.ndarray:
        return _grad_scale(self.rounds, self.n, self.grad_mask, self.alive)

    def extras_dict(self) -> dict[str, np.ndarray]:
        return dict(self.extras) if self.extras else {}

    def num_batches(self) -> int:
        """Fused sweeps the engine performs (vs kmax*rounds in the raw path)."""
        return int(self.batch_active.sum())


def coalesce_schedule(schedule: Schedule) -> CoalescedSchedule:
    """Compile a raw per-event schedule into coalesced batches.

    Greedy in event order: event e merges into the current batch iff none of
    its involved workers already appears in the batch — disjoint matchings
    commute and exp(dt1 A) exp(dt2 A) = exp((dt1+dt2) A) lets each worker
    carry its own accumulated mixing horizon, so the merge is exact up to
    float reordering.  Masked slots are dropped outright.
    """
    R, K, n = schedule.partners.shape
    idx = np.arange(n)
    raw_ext = schedule.extras_dict()
    per_round: list[list[tuple]] = []
    for r in range(R):
        batches: list[tuple] = []  # (partner, wtime, {name: (n,) attr})
        busy = np.zeros(n, dtype=bool)  # workers involved in current batch
        for e in range(K):
            if not schedule.event_mask[r, e]:
                continue
            p = schedule.partners[r, e]
            involved = p != idx
            if not involved.any():
                continue
            t = schedule.event_times[r, e]
            if batches and not (busy & involved).any():
                # disjoint from the open batch: merge
                partner, wtime, ext = batches[-1]
                partner[involved] = p[involved]
                wtime[involved] = t
            else:
                partner = idx.astype(np.int32).copy()
                partner[involved] = p[involved]
                wtime = np.zeros(n, dtype=np.float32)
                wtime[involved] = t
                ext = {k: np.zeros(n, a.dtype) for k, a in raw_ext.items()}
                batches.append((partner, wtime, ext))
                busy = np.zeros(n, dtype=bool)
            for k, a in raw_ext.items():
                ext[k][involved] = a[r, e, involved]
            busy |= involved
        per_round.append(batches)

    B = max(1, max(len(b) for b in per_round))
    partners = np.tile(idx.astype(np.int32), (R, B, 1))
    wtimes = np.zeros((R, B, n), dtype=np.float32)
    batch_active = np.zeros((R, B), dtype=bool)
    extras = {k: np.zeros((R, B, n), a.dtype) for k, a in raw_ext.items()} \
        if raw_ext else None
    for r, batches in enumerate(per_round):
        for b, (partner, wtime, ext) in enumerate(batches):
            partners[r, b] = partner
            wtimes[r, b] = wtime
            batch_active[r, b] = True
            if extras is not None:
                for k in extras:
                    extras[k][r, b] = ext[k]
    return CoalescedSchedule(partners, wtimes, batch_active,
                             schedule.grad_times.astype(np.float32),
                             grad_mask=schedule.grad_mask,
                             alive=schedule.alive, extras=extras)


@dataclasses.dataclass(frozen=True)
class EventStream:
    """A coalesced schedule flattened into ONE step stream.

    The engine replays ``S = num_batches + rounds`` steps — one per fused
    comm batch plus one per gradient tick.  Each step applies its own update
    then the mixing segment to the NEXT step ([P_i, mix(d_{i+1})] grouping);
    ``prologue`` is the per-worker mixing from the start clocks ``t0`` to
    each worker's first event.  All segments are resolved host-side.

    Shapes (S = steps, n = workers, R = rounds):
      prologue   (n,) f32
      partners   (S, n) int32 — identity rows for gradient steps
      dt_next    (S, n) f32
      is_grad    (S,) bool
      grad_scale (S, n) f32  — gradient-application scale at gradient steps
      grad_pos   (R,) int32  — step index of round r's gradient tick
      t_final    (n,) f32    — per-worker clock after the last step
      extras     dict of named (S, n) arrays (zero rows at gradient ticks)
    """

    prologue: np.ndarray
    partners: np.ndarray
    dt_next: np.ndarray
    is_grad: np.ndarray
    grad_scale: np.ndarray
    grad_pos: np.ndarray
    t_final: np.ndarray
    extras: dict[str, np.ndarray] | None = None

    @property
    def steps(self) -> int:
        return self.partners.shape[0]


def coalesced_stream(cs: CoalescedSchedule, t0: np.ndarray,
                     round_batches: np.ndarray | None = None) -> EventStream:
    """Flatten a coalesced schedule into an EventStream given start clocks.

    A detached worker's clock never advances (zero dt segments), a
    straggler's masked gradient tick still advances its clock and mixing
    horizon but contributes grad_scale 0.

    ``round_batches`` (R,) pads round r to that many comm steps with
    identity groups (self-partner p2p, zero-dt mixing, zero extras), an
    exact no-op of the replay; ``stack_streams`` uses it so that the
    gradient ticks of B ragged worlds land on the same step.
    """
    R, B, n = cs.partners.shape
    idx = np.arange(n)
    alive = cs.alive_arr()
    gscale = cs.grad_scale()
    cs_ext = cs.extras_dict()
    partners, dt_next, is_grad, grad_scale, grad_pos = [], [], [], [], []
    ext_rows: dict[str, list[np.ndarray]] = {k: [] for k in cs_ext}
    ext_zero = {k: np.zeros(n, a.dtype) for k, a in cs_ext.items()}
    prologue = None
    tl = np.array(t0, np.float32).copy()

    def emit(partner, delta, grad, gs, ext):
        nonlocal prologue
        if prologue is None:
            prologue = delta
        else:
            dt_next[-1] = delta
        partners.append(partner)
        dt_next.append(np.zeros(n, np.float32))
        is_grad.append(grad)
        grad_scale.append(gs)
        for k in ext_rows:
            ext_rows[k].append(ext[k])

    ones = np.ones(n, np.float32)
    idt = idx.astype(np.int32)
    for r in range(R):
        emitted = 0
        for b in range(B):
            if not cs.batch_active[r, b]:
                continue
            inv = cs.partners[r, b] != idx
            delta = np.zeros(n, np.float32)
            delta[inv] = cs.wtimes[r, b, inv] - tl[inv]
            tl[inv] = cs.wtimes[r, b, inv]
            emit(cs.partners[r, b].astype(np.int32), delta, False, ones,
                 {k: a[r, b] for k, a in cs_ext.items()})
            emitted += 1
        if round_batches is not None:
            target = int(round_batches[r])
            if target < emitted:
                raise ValueError(
                    f"round_batches[{r}] = {target} is below this "
                    f"schedule's {emitted} active batches")
            for _ in range(target - emitted):
                emit(idt, np.zeros(n, np.float32), False, ones, ext_zero)
        adv = alive[r]
        delta = np.where(adv, cs.grad_times[r] - tl, 0.0).astype(np.float32)
        tl = np.where(adv, cs.grad_times[r], tl).astype(np.float32)
        emit(idx.astype(np.int32), delta, True, gscale[r], ext_zero)
        grad_pos.append(len(partners) - 1)

    return EventStream(
        prologue=prologue,
        partners=np.stack(partners),
        dt_next=np.stack(dt_next),
        is_grad=np.asarray(is_grad, bool),
        grad_scale=np.stack(grad_scale).astype(np.float32),
        grad_pos=np.asarray(grad_pos, np.int32),
        t_final=tl.copy(),
        extras={k: np.stack(v) for k, v in ext_rows.items()}
        if ext_rows else None,
    )


# ---------------------------------------------------------------------------
# Many-worlds batching (the world-batched replay)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedSchedule:
    """B per-event schedules padded to one (R, B, K, n) block, the world
    axis right after the round axis.  Ragged per-round event counts cost
    masked identity slots (``concat_schedules``' padding), never a branch;
    ``grad_scale``/``alive``/``extras`` are materialized."""

    partners: np.ndarray     # (R, B, K, n) int32
    event_times: np.ndarray  # (R, B, K) f32
    event_mask: np.ndarray   # (R, B, K) bool
    grad_times: np.ndarray   # (R, B, n) f32
    grad_scale: np.ndarray   # (R, B, n) f32
    alive: np.ndarray        # (R, B, n) bool
    extras: dict[str, np.ndarray] | None = None  # each (R, B, K, n)

    @property
    def rounds(self) -> int:
        return self.partners.shape[0]

    @property
    def batch(self) -> int:
        return self.partners.shape[1]

    @property
    def n(self) -> int:
        return self.partners.shape[3]

    def extras_dict(self) -> dict[str, np.ndarray]:
        return dict(self.extras) if self.extras else {}


def _pad_events_k(partners, event_times, event_mask, kmax: int):
    """Pad the K axis with masked identity slots (times repeat the row's
    last value); a K = 0 schedule pads with zero times (all masked)."""
    R, K, n = partners.shape
    if K == kmax:
        return partners, event_times, event_mask
    pad_p = np.tile(np.arange(n, dtype=np.int32), (R, kmax - K, 1))
    pad_t = np.repeat(event_times[:, -1:], kmax - K, axis=1) if K else \
        np.zeros((R, kmax), event_times.dtype)
    return (np.concatenate([partners, pad_p], axis=1),
            np.concatenate([event_times, pad_t], axis=1),
            np.concatenate([event_mask, np.zeros((R, kmax - K), bool)],
                           axis=1))


def _union_keys(extra_dicts: list[dict]) -> list[str]:
    keys: list[str] = []
    for d in extra_dicts:
        keys += [k for k in d if k not in keys]
    return keys


def stack_schedules(schedules: list[Schedule]) -> BatchedSchedule:
    """Stack B worlds' schedules, which must share (rounds, n); ragged K is
    padded to the widest world, extras are unioned (a world without a key
    contributes zeros: fresh, honest)."""
    if not schedules:
        raise ValueError("need at least one schedule")
    R, n = schedules[0].rounds, schedules[0].n
    for i, s in enumerate(schedules):
        if s.rounds != R or s.n != n:
            raise ValueError(
                f"schedules[{i}] has (rounds, n) = ({s.rounds}, {s.n}); a "
                f"batch must share one frame, expected ({R}, {n})")
    kmax = max(s.partners.shape[1] for s in schedules)
    parts, times, masks = [], [], []
    for s in schedules:
        p, t, m = _pad_events_k(s.partners, s.event_times, s.event_mask,
                                kmax)
        parts.append(p)
        times.append(t)
        masks.append(m)
    ex_dicts = [s.extras_dict() for s in schedules]
    keys = _union_keys(ex_dicts)
    extras = None
    if keys:
        extras = {}
        for k in keys:
            dtype = next(d[k].dtype for d in ex_dicts if k in d)
            chunks = []
            for d in ex_dicts:
                a = d.get(k)
                if a is None:
                    a = np.zeros((R, kmax, n), dtype)
                elif a.shape[1] < kmax:
                    a = np.concatenate(
                        [a, np.zeros((R, kmax - a.shape[1], n), a.dtype)],
                        axis=1)
                chunks.append(a)
            extras[k] = np.stack(chunks, axis=1)
    return BatchedSchedule(
        partners=np.stack(parts, axis=1),
        event_times=np.stack(times, axis=1).astype(np.float32),
        event_mask=np.stack(masks, axis=1),
        grad_times=np.stack([s.grad_times for s in schedules],
                            axis=1).astype(np.float32),
        grad_scale=np.stack([s.grad_scale() for s in schedules], axis=1),
        alive=np.stack([s.alive_arr() for s in schedules], axis=1),
        extras=extras)


@dataclasses.dataclass(frozen=True)
class BatchedStream:
    """B event streams aligned to one shared step skeleton: every round of
    every world is padded to the round's largest batch count (identity
    groups), so ``is_grad`` and ``grad_pos`` are shared and the batched
    replay keeps the serial replay's one branch per step.

    Shapes (S = shared steps, B = worlds, n = workers, R = rounds):
      prologue (B, n) f32; partners (S, B, n) int32; dt_next (S, B, n) f32;
      is_grad (S,) bool; grad_scale (S, B, n) f32; grad_pos (R,) int32;
      t_final (B, n) f32; extras: named (S, B, n) arrays (union over
      worlds, missing keys zero = fresh/honest)
    """

    prologue: np.ndarray
    partners: np.ndarray
    dt_next: np.ndarray
    is_grad: np.ndarray
    grad_scale: np.ndarray
    grad_pos: np.ndarray
    t_final: np.ndarray
    extras: dict[str, np.ndarray] | None = None

    @property
    def steps(self) -> int:
        return self.partners.shape[0]

    @property
    def batch(self) -> int:
        return self.partners.shape[1]

    def extras_dict(self) -> dict[str, np.ndarray]:
        return dict(self.extras) if self.extras else {}


def stack_streams(cs_list: list[CoalescedSchedule],
                  t0: np.ndarray) -> BatchedStream:
    """Compile B coalesced schedules + (B, n) start clocks into one
    BatchedStream.  Round r contributes ``max_b active_batches_b(r)`` comm
    steps for every world; worlds with fewer replay identity groups, so
    the gradient ticks of all worlds coincide step for step."""
    if not cs_list:
        raise ValueError("need at least one coalesced schedule")
    R, n = cs_list[0].rounds, cs_list[0].n
    for i, cs in enumerate(cs_list):
        if cs.rounds != R or cs.n != n:
            raise ValueError(
                f"coalesced schedules[{i}] has (rounds, n) = "
                f"({cs.rounds}, {cs.n}); a batch must share one frame, "
                f"expected ({R}, {n})")
    t0 = np.asarray(t0, np.float32)
    if t0.shape != (len(cs_list), n):
        raise ValueError(f"t0 must be (B, n) = ({len(cs_list)}, {n}) start "
                         f"clocks, got {t0.shape}")
    round_batches = np.stack(
        [cs.batch_active.sum(axis=1) for cs in cs_list]).max(axis=0)
    streams = [coalesced_stream(cs, t0[i], round_batches=round_batches)
               for i, cs in enumerate(cs_list)]
    s0 = streams[0]
    for st in streams[1:]:
        # same rounds + same per-round batch counts => identical skeleton
        assert st.steps == s0.steps
        assert np.array_equal(st.is_grad, s0.is_grad)
        assert np.array_equal(st.grad_pos, s0.grad_pos)
    ex_dicts = [st.extras or {} for st in streams]
    keys = _union_keys(ex_dicts)
    extras = None
    if keys:
        extras = {}
        for k in keys:
            dtype = next(d[k].dtype for d in ex_dicts if k in d)
            extras[k] = np.stack(
                [d.get(k, np.zeros((s0.steps, n), dtype))
                 for d in ex_dicts], axis=1)
    return BatchedStream(
        prologue=np.stack([st.prologue for st in streams]),
        partners=np.stack([st.partners for st in streams], axis=1),
        dt_next=np.stack([st.dt_next for st in streams], axis=1),
        is_grad=s0.is_grad,
        grad_scale=np.stack([st.grad_scale for st in streams], axis=1),
        grad_pos=s0.grad_pos,
        t_final=np.stack([st.t_final for st in streams]),
        extras=extras)


def empirical_laplacian(schedule: Schedule, rounds: int | None = None
                        ) -> np.ndarray:
    """Empirical expected Laplacian from realized matchings (paper App
    E.2)."""
    R = rounds or schedule.rounds
    n = schedule.n
    L = np.zeros((n, n))
    for r in range(R):
        for k in range(schedule.partners.shape[1]):
            if not schedule.event_mask[r, k]:
                continue
            p = schedule.partners[r, k]
            for i in range(n):
                j = int(p[i])
                if j > i:
                    L[i, i] += 1
                    L[j, j] += 1
                    L[i, j] -= 1
                    L[j, i] -= 1
    return L / R


# --------------------------------------------------------------------------
# Shard-aware schedule compilation: partition a batched stream's matchings
# over a worker-sharded replay mesh (``launch/mesh_replay.py``).  Host
# numpy, exactly the JAX package's.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-compiled partition of a :class:`BatchedStream` over ``n_shards``
    equal worker shards.

    Every comm step's matching splits into INTRA-shard pairs (both
    endpoints on one shard — the partner involution restricted to a shard
    is still an involution, because a pair is either wholly intra or both
    of its directed reads are cross) and CROSS-shard boundary reads.  The
    intra reads keep the fused per-shard gather (``local_partner`` indexes
    the shard's own (Ws, D) rows); the cross reads are served by the
    bounded-staleness permute ring: each shard publishes the boundary rows
    its peers will read this step (``pub_row``/``pub_slot``, staleness
    resolved by the PUBLISHER against its own snapshot ring — an exact
    copy of what the single-device ``ring_read`` would have produced),
    one gather over the shards stacks the published blocks into a
    hop-ordered (NS, B, nb, D) pool (``flatbuf.ring_pool_exchange``), and
    readers index the pool by ``(hop, pool_pos)``.

    Shapes (S = steps, B = worlds, n = workers, NS = shards,
    Ws = n // NS, nb = max boundary rows one shard serves in one step):
      local_partner (S, B, n) int32 — partner % Ws for intra reads; the
                    reader's own local row for cross/idle reads (a valid
                    self-gather whose value the cross select discards)
      is_cross      (S, B, n) bool
      hop           (S, B, n) int32 — (reader_shard - source_shard) % NS,
                    the pool index the read is served from (0 if intra)
      pool_pos      (S, B, n) int32 — position inside the source shard's
                    published block (0 if intra)
      pub_row       (S, NS, B, nb) int32 — for each DESTINATION-facing
                    source shard u: the local rows u publishes at this
                    step, ordered by reader index (padding = row 0)
      pub_slot      (S, NS, B, nb) int32 — ring slot each published row is
                    resolved at (the sentinel ``horizon`` = fresh)
      cross_reads   (S, B) int64 — boundary-read counts (telemetry)
    """

    n_shards: int
    shard_size: int
    pool_width: int
    local_partner: np.ndarray
    is_cross: np.ndarray
    hop: np.ndarray
    pool_pos: np.ndarray
    pub_row: np.ndarray
    pub_slot: np.ndarray
    cross_reads: np.ndarray


def shard_partition(partners: np.ndarray, src_slot: np.ndarray,
                    n_shards: int, horizon: int) -> ShardPlan:
    """Partition batched-stream matchings into intra-shard groups and
    cross-shard boundary exchanges.

    ``partners`` is the stream's (S, B, n) global partner involution,
    ``src_slot`` the host-resolved (S, B, n) ring slots (sentinel =
    ``horizon`` = fresh) the reads are served at — the SAME array the
    single-device channel scan consumes, so the publisher-side resolution
    is bitwise the single-device ``ring_read``.
    """
    partners = np.asarray(partners)
    S, B, n = partners.shape
    if n % n_shards != 0:
        raise ValueError(f"worker axis {n} is not divisible by "
                         f"{n_shards} shards")
    ws = n // n_shards
    rdr = np.arange(n, dtype=np.int64)
    rdr_shard = rdr // ws                       # (n,)
    p_shard = partners.astype(np.int64) // ws   # (S, B, n)
    involved = partners != rdr
    is_cross = involved & (p_shard != rdr_shard)
    hop = np.where(is_cross, (rdr_shard - p_shard) % n_shards, 0
                   ).astype(np.int32)
    local_partner = np.where(is_cross | ~involved, rdr % ws,
                             partners.astype(np.int64) % ws
                             ).astype(np.int32)
    # rank each cross read among same-(step, world, source-shard) reads,
    # reader-index ascending — the order the source shard publishes in
    pool_pos = np.zeros((S, B, n), np.int32)
    counts = np.zeros((S, B, n_shards), np.int64)
    for u in range(n_shards):
        m = is_cross & (p_shard == u)
        pool_pos = np.where(m, np.cumsum(m, axis=-1) - 1, pool_pos
                            ).astype(np.int32)
        counts[:, :, u] = m.sum(axis=-1)
    nb = max(int(counts.max()), 1)
    pub_row = np.zeros((S, n_shards, B, nb), np.int32)
    pub_slot = np.full((S, n_shards, B, nb), horizon, np.int32)
    s_i, b_i, r_i = np.nonzero(is_cross)
    u_i = p_shard[s_i, b_i, r_i]
    k_i = pool_pos[s_i, b_i, r_i]
    pub_row[s_i, u_i, b_i, k_i] = (partners[s_i, b_i, r_i] % ws)
    pub_slot[s_i, u_i, b_i, k_i] = np.asarray(src_slot)[s_i, b_i, r_i]
    return ShardPlan(n_shards=n_shards, shard_size=ws, pool_width=nb,
                     local_partner=local_partner, is_cross=is_cross,
                     hop=hop, pool_pos=pool_pos,
                     pub_row=pub_row, pub_slot=pub_slot,
                     cross_reads=is_cross.sum(axis=-1).astype(np.int64))


def shard_lag_stale(partners: np.ndarray, stale: np.ndarray,
                    step_round: np.ndarray, n_shards: int, lag: int
                    ) -> np.ndarray:
    """Impose the permute ring's staleness floor ``lag`` on cross-shard
    reads of a batched stream.

    A lag-L ring serves boundary reads from snapshots at least L rounds
    old: ``stale' = min(max(stale, L), rounds_elapsed)`` on cross reads
    (the clamp to elapsed rounds is the same guarantee ``ChannelModel``
    compiles — no slot is read before it was written).  Intra-shard reads
    keep their scheduled staleness untouched, so lag > 0 is EXACTLY a
    single-device replay of the same schedule with rewritten ``stale``
    extras — the per-event ``DelayProcess`` reference the tests pin
    against.
    """
    partners = np.asarray(partners)
    S, B, n = partners.shape
    ws = n // n_shards
    rdr = np.arange(n, dtype=np.int64)
    is_cross = (partners != rdr) & \
        (partners.astype(np.int64) // ws != rdr // ws)
    eff = np.minimum(np.maximum(np.asarray(stale, np.int64), int(lag)),
                     step_round[:, None, None])
    return np.where(is_cross, eff, stale).astype(np.int32)
