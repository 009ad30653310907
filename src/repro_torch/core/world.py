"""Declarative World API: compile scenarios instead of passing kwargs.

A ``World`` is a declarative, serializable description of one scenario: a
topology, per-worker speeds, per-link rates, failures, an unreliable
channel, a self-healing defense, an algorithm and a serving load.
``world.compile(rounds, seed)`` lowers it to one ``events.Schedule``, plain
numpy event data that every replay consumes; a ``WorldSweep`` names a grid
of worlds that ``Simulator.run_worlds`` replays in one batched call.

This is the port of the JAX package's ``repro.core.world``: the same
classes, validation and JSON, and every compiled array equal to the JAX
package's for the same spec and seed.  A world's ``telemetry`` spec
(``core/telemetry.py``) rides along to the replay, which then records its
per-round columns.

Compilation (all host-side numpy):

  1. topology + faults -> segments, each a (graph, rounds, active mask):
     ``PhaseSwitch`` cuts the timeline at fixed rounds, ``ChurnProcess``
     samples a per-worker failure/repair Markov chain (its own rng stream)
     and cuts at every aliveness change;
  2. each segment samples its own Poisson events (seed ``seed + p``, times
     offset by the segment start);
  3. ``events.concat_schedules`` fuses the segments; the algorithm's
     gradient clock, the channel, the defense's comm controller and the
     serving load then ride on the fused schedule, each from its own rng
     stream.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import numpy as np

from .a2cid2 import Algorithm
from .channel import ChannelModel
from .defense import AdaptiveDefense
from .graphs import Graph, TopologyPhase, TopologySchedule
from .telemetry import Telemetry

# rng-stream tag for churn draws — independent of the schedule's main stream
# (events.py uses 0x48455 for straggler thinning)
_CHURN_TAG = 0xC50C4
# rng-stream tag for serving-load draws (arrival trace): independent of BOTH
# the schedule and churn streams, so every world sharing a ServeLoad spec +
# seed sees the identical request trace regardless of topology/channel/faults
_SERVE_TAG = 0x5E17E
# reserved extras key: per-round request-arrival counts at event slot 0
SERVE_ARRIVE_KEY = "arrive"


def _as_float_tuple(x, field: str) -> tuple[float, ...] | None:
    if x is None:
        return None
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim != 1:
        raise ValueError(
            f"{field} must be a 1-D sequence, got shape {arr.shape}")
    if not np.all(np.isfinite(arr)):
        raise ValueError(f"{field} must be finite, got {arr}")
    return tuple(float(v) for v in arr)


def _as_bool_tuple(x, field: str) -> tuple[bool, ...] | None:
    if x is None:
        return None
    arr = np.asarray(x)
    if arr.ndim != 1:
        raise ValueError(
            f"{field} must be a 1-D sequence, got shape {arr.shape}")
    if arr.dtype != bool and not np.all(np.isin(arr, (0, 1))):
        raise ValueError(f"{field} must be boolean, got dtype {arr.dtype}")
    return tuple(bool(v) for v in arr)


# ---------------------------------------------------------------- components

@dataclasses.dataclass(frozen=True)
class WorkerModel:
    """Per-worker physics.

    grad_rates — per-worker gradient-tick rates in [0, 1] relative to the
      unit tick process (straggler thinning; DESIGN.md §8).  None = all 1.
    active — static churn mask: ``active[i] = False`` detaches worker i for
      the whole world (no matchings, no gradients, frozen clock).
    """

    grad_rates: tuple[float, ...] | None = None
    active: tuple[bool, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "grad_rates",
                           _as_float_tuple(self.grad_rates,
                                           "workers.grad_rates"))
        object.__setattr__(self, "active",
                           _as_bool_tuple(self.active, "workers.active"))
        if self.grad_rates is not None:
            bad = [r for r in self.grad_rates if not 0.0 <= r <= 1.0]
            if bad:
                raise ValueError(
                    "workers.grad_rates are thinning probabilities and must "
                    f"lie in [0, 1], got {bad}")

    def grad_rates_arr(self) -> np.ndarray | None:
        if self.grad_rates is None:
            return None
        return np.asarray(self.grad_rates, dtype=np.float64)

    def active_arr(self) -> np.ndarray | None:
        if self.active is None:
            return None
        return np.asarray(self.active, dtype=bool)

    def to_dict(self) -> dict:
        return {"grad_rates": None if self.grad_rates is None
                else list(self.grad_rates),
                "active": None if self.active is None else list(self.active)}

    @staticmethod
    def from_dict(d: dict) -> "WorkerModel":
        return WorkerModel(grad_rates=d.get("grad_rates"),
                           active=d.get("active"))


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-link physics: how often each edge fires, and what a firing costs.

    Exactly one of two descriptions (or neither, for topology-default rates):

    rates — explicit per-edge event rates overriding ``graph.rates``
      (aligned with the topology's edge list).
    bandwidth_bytes_per_s + msg_bytes — bandwidth-aware rates: a link of
      capacity ``bw`` moves one ``msg_bytes`` message every ``msg_bytes/bw``
      seconds, so edge event rates are proportional to bandwidth, normalized
      so the MEAN worker communicates once per unit simulated time (the
      ``comms_per_grad`` world knob scales from there).  ``bandwidth`` may
      be a scalar (uniform links) or per-edge.

    grad_seconds — wall-clock seconds of one gradient tick, used only by the
      wall-clock mapping ``round_seconds`` (couple it to the roofline terms
      of a roofline model for real models).
    per_edge — force the Def 3.1 single-pair point process on/off
      (None = auto: per-edge iff rates are non-uniform vs the topology).
    """

    rates: tuple[float, ...] | None = None
    bandwidth_bytes_per_s: float | tuple[float, ...] | None = None
    msg_bytes: float | None = None
    grad_seconds: float = 0.0
    per_edge: bool | None = None

    def __post_init__(self):
        object.__setattr__(self, "rates",
                           _as_float_tuple(self.rates, "links.rates"))
        bw = self.bandwidth_bytes_per_s
        if bw is not None and not np.isscalar(bw):
            bw = _as_float_tuple(bw, "links.bandwidth_bytes_per_s")
            object.__setattr__(self, "bandwidth_bytes_per_s", bw)
        elif bw is not None:
            object.__setattr__(self, "bandwidth_bytes_per_s", float(bw))
        if self.rates is not None and self.bandwidth_bytes_per_s is not None:
            raise ValueError("links: give either explicit rates OR "
                             "bandwidth_bytes_per_s, not both")
        if (self.bandwidth_bytes_per_s is None) != (self.msg_bytes is None):
            raise ValueError("links: bandwidth_bytes_per_s and msg_bytes "
                             "must be given together")
        if self.msg_bytes is not None and not self.msg_bytes > 0:
            raise ValueError(f"links.msg_bytes must be > 0, "
                             f"got {self.msg_bytes}")
        if self.rates is not None and any(r < 0 for r in self.rates):
            raise ValueError(f"links.rates must be >= 0, got {self.rates}")
        if self.bandwidth_bytes_per_s is not None:
            arr = np.atleast_1d(np.asarray(self.bandwidth_bytes_per_s))
            if not np.all(arr > 0):
                raise ValueError("links.bandwidth_bytes_per_s must be > 0, "
                                 f"got {self.bandwidth_bytes_per_s}")
        if self.grad_seconds < 0:
            raise ValueError(f"links.grad_seconds must be >= 0, "
                             f"got {self.grad_seconds}")

    @property
    def is_default(self) -> bool:
        return self.rates is None and self.bandwidth_bytes_per_s is None

    def _bandwidth_arr(self, graph: Graph) -> np.ndarray:
        bw = np.asarray(self.bandwidth_bytes_per_s, dtype=np.float64)
        if bw.ndim == 0:
            return np.full(graph.num_edges, float(bw))
        if bw.shape != (graph.num_edges,):
            raise ValueError(
                "links.bandwidth_bytes_per_s must be scalar or shape "
                f"({graph.num_edges},) = (num_edges,) for topology "
                f"'{graph.name}', got {bw.shape}")
        return bw

    def edge_rates(self, graph: Graph) -> np.ndarray | None:
        """Per-edge event rates this model induces on ``graph`` (None =
        keep the topology's own rates)."""
        if self.rates is not None:
            arr = np.asarray(self.rates, dtype=np.float64)
            if arr.shape != (graph.num_edges,):
                raise ValueError(
                    f"links.rates must have shape ({graph.num_edges},) = "
                    f"(num_edges,) for topology '{graph.name}', "
                    f"got {arr.shape}")
            return arr
        if self.bandwidth_bytes_per_s is not None:
            cap = self._bandwidth_arr(graph) / float(self.msg_bytes)
            # normalize so the mean worker rate is 1 (sum of worker rates =
            # 2 * sum of edge rates = n); comms_per_grad scales from there
            return cap * (graph.n / 2.0) / cap.sum()
        return None

    def seconds_per_event(self, graph: Graph) -> np.ndarray:
        """(E,) wall seconds one p2p message occupies each link."""
        if self.bandwidth_bytes_per_s is None:
            raise ValueError("seconds_per_event needs a bandwidth-aware "
                             "LinkModel (bandwidth_bytes_per_s + msg_bytes)")
        return float(self.msg_bytes) / self._bandwidth_arr(graph)

    def round_seconds(self, schedule, graph: Graph,
                      rounds: range | None = None) -> np.ndarray:
        """Wall seconds per simulated round under this link model.

        Links transfer in parallel; events on the SAME link serialize, so a
        round costs ``grad_seconds`` plus the busiest link's transfer time.
        This is a wall-clock x-axis for topology sweeps.  ``rounds``
        restricts to a slice of the schedule (``World.round_seconds`` uses
        it to apply each segment's own graph); default = all rounds.
        """
        spe = self.seconds_per_event(graph)
        eidx = graph.edge_index()
        rs = range(schedule.rounds) if rounds is None else rounds
        out = np.full(len(rs), float(self.grad_seconds))
        for o, r in enumerate(rs):
            busy = np.zeros(max(graph.num_edges, 1))
            for k in range(schedule.partners.shape[1]):
                if not schedule.event_mask[r, k]:
                    continue
                p = schedule.partners[r, k]
                for i in range(schedule.n):
                    j = int(p[i])
                    if j > i:
                        e = eidx.get((i, j))
                        if e is not None:
                            busy[e] += spe[e]
            out[o] += busy.max()
        return out

    def to_dict(self) -> dict:
        bw = self.bandwidth_bytes_per_s
        return {"rates": None if self.rates is None else list(self.rates),
                "bandwidth_bytes_per_s": list(bw) if isinstance(bw, tuple)
                else bw,
                "msg_bytes": self.msg_bytes,
                "grad_seconds": self.grad_seconds,
                "per_edge": self.per_edge}

    @staticmethod
    def from_dict(d: dict) -> "LinkModel":
        return LinkModel(rates=d.get("rates"),
                         bandwidth_bytes_per_s=d.get("bandwidth_bytes_per_s"),
                         msg_bytes=d.get("msg_bytes"),
                         grad_seconds=d.get("grad_seconds", 0.0),
                         per_edge=d.get("per_edge"))


# -------------------------------------------------------------------- faults

@dataclasses.dataclass(frozen=True)
class ChurnProcess:
    """Poisson failure/repair churn: each worker is a 2-state Markov chain
    (alive -> dead at rate ``fail_rate`` per round, dead -> alive at
    ``repair_rate``), sampled per round from a dedicated rng stream and
    compiled onto the schedule as segments of constant aliveness — detached
    rows keep the exact fixed-point/frozen-clock semantics of DESIGN.md §8.

    workers — optional subset of worker ids eligible to fail (None = all).
    """

    fail_rate: float
    repair_rate: float
    workers: tuple[int, ...] | None = None

    def __post_init__(self):
        if not (np.isfinite(self.fail_rate) and self.fail_rate >= 0):
            raise ValueError(
                f"ChurnProcess.fail_rate must be >= 0, got {self.fail_rate}")
        if not (np.isfinite(self.repair_rate) and self.repair_rate >= 0):
            raise ValueError(f"ChurnProcess.repair_rate must be >= 0, "
                             f"got {self.repair_rate}")
        if self.workers is not None:
            object.__setattr__(self, "workers",
                               tuple(int(w) for w in self.workers))

    def sample_alive(self, rounds: int, n: int, seed: int) -> np.ndarray:
        """(R, n) bool aliveness trajectory.  Round 0 starts all-alive; the
        chain then takes one transition per round.  Draws come from an rng
        stream independent of the schedule's — the aliveness PATTERN never
        depends on how events were sampled.  (The compiled events themselves
        DO change when churn cuts the timeline into differently-seeded
        segments; only a churn process that never fires leaves the event
        stream bit-for-bit intact.)"""
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), _CHURN_TAG]))
        p_fail = 1.0 - np.exp(-self.fail_rate)
        p_repair = 1.0 - np.exp(-self.repair_rate)
        eligible = np.zeros(n, dtype=bool)
        if self.workers is None:
            eligible[:] = True
        else:
            for w in self.workers:
                if not 0 <= w < n:
                    raise ValueError(f"ChurnProcess.workers entry {w} outside "
                                     f"[0, {n})")
                eligible[w] = True
        alive = np.ones((rounds, n), dtype=bool)
        state = np.ones(n, dtype=bool)
        u = rng.uniform(size=(rounds, n))
        for r in range(1, rounds):
            flip = np.where(state, u[r] < p_fail, u[r] < p_repair) & eligible
            state = np.where(flip, ~state, state)
            alive[r] = state
        return alive

    def to_dict(self) -> dict:
        return {"kind": "churn", "fail_rate": self.fail_rate,
                "repair_rate": self.repair_rate,
                "workers": None if self.workers is None
                else list(self.workers)}


@dataclasses.dataclass(frozen=True)
class PhaseSwitch:
    """Deterministic mid-run world change at a fixed round: a new topology
    (None = keep the current graph) and/or a new static active mask applying
    from this round on (None = revert to the worker model's base mask)."""

    at_round: int
    topology: Graph | None = None
    active: tuple[bool, ...] | None = None

    def __post_init__(self):
        if self.at_round <= 0:
            raise ValueError(
                f"PhaseSwitch.at_round must be >= 1, got {self.at_round}")
        object.__setattr__(self, "active",
                           _as_bool_tuple(self.active, "PhaseSwitch.active"))

    def to_dict(self) -> dict:
        return {"kind": "phase_switch", "at_round": self.at_round,
                "topology": None if self.topology is None
                else self.topology.to_dict(),
                "active": None if self.active is None else list(self.active)}


def _fault_from_dict(d: dict):
    kind = d.get("kind")
    if kind == "churn":
        return ChurnProcess(d["fail_rate"], d["repair_rate"],
                            workers=d.get("workers"))
    if kind == "phase_switch":
        topo = d.get("topology")
        return PhaseSwitch(d["at_round"],
                           topology=None if topo is None
                           else Graph.from_dict(topo),
                           active=d.get("active"))
    raise ValueError(f"unknown fault kind {kind!r} "
                     "(expected 'churn' or 'phase_switch')")


# --------------------------------------------------------------- serving load

@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """A materialized arrival trace: one row per request, sorted by arrival
    round.  Derived data (``ServeLoad.sample_trace``), not serialized — the
    (spec, rounds, seed) triple regenerates it bit-for-bit."""

    arrival_round: np.ndarray  # (N,) int32
    prompt_len: np.ndarray     # (N,) int32
    gen_len: np.ndarray        # (N,) int32

    @property
    def num_requests(self) -> int:
        return int(self.arrival_round.shape[0])

    def counts(self, rounds: int) -> np.ndarray:
        """(rounds,) arrivals per round."""
        return np.bincount(self.arrival_round,
                           minlength=rounds).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ServeLoad:
    """The serving-workload axis of a World (DESIGN.md §14): a shared
    request arrival trace the gossip-serving fleet admits from while its
    replicas keep averaging.

    rate — mean fleet-wide request arrivals per round (Poisson), ignored
      when explicit ``arrivals`` are given.
    prompt_len / gen_len — inclusive (lo, hi) ranges sampled uniformly per
      request (heterogeneous work, the continuous-batching stressor).
    arrive_frac — arrivals land in rounds ``[0, ceil(arrive_frac * R))``;
      the remaining tail is drain headroom.
    arrivals — optional explicit per-round counts (a replayed trace);
      padded/truncated to the compiled horizon.

    Draws come from a dedicated rng stream (seed x ``_SERVE_TAG``), so two
    worlds differing in topology/channel/faults but sharing a ServeLoad and
    seed see the IDENTICAL trace — the "one request trace across fleets"
    contract a serving benchmark relies on.
    """

    rate: float = 1.0
    prompt_len: tuple[int, int] = (4, 8)
    gen_len: tuple[int, int] = (4, 16)
    arrive_frac: float = 0.6
    arrivals: tuple[int, ...] | None = None

    def __post_init__(self):
        if not (np.isfinite(self.rate) and self.rate >= 0):
            raise ValueError(f"ServeLoad.rate must be >= 0, got {self.rate}")
        for name in ("prompt_len", "gen_len"):
            rng_ = getattr(self, name)
            rng_ = tuple(int(v) for v in rng_)
            object.__setattr__(self, name, rng_)
            if len(rng_) != 2 or not 1 <= rng_[0] <= rng_[1]:
                raise ValueError(f"ServeLoad.{name} must be (lo, hi) with "
                                 f"1 <= lo <= hi, got {rng_}")
        if not 0.0 < self.arrive_frac <= 1.0:
            raise ValueError(f"ServeLoad.arrive_frac must lie in (0, 1], "
                             f"got {self.arrive_frac}")
        if self.arrivals is not None:
            arr = tuple(int(a) for a in self.arrivals)
            if any(a < 0 for a in arr):
                raise ValueError(f"ServeLoad.arrivals must be >= 0, got "
                                 f"{[a for a in arr if a < 0]}")
            object.__setattr__(self, "arrivals", arr)

    def _rng(self, seed: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([int(seed), _SERVE_TAG]))

    def sample_counts(self, rounds: int, seed: int = 0) -> np.ndarray:
        """(rounds,) arrivals per round — explicit trace or Poisson draws
        over the arrival window."""
        if self.arrivals is not None:
            out = np.zeros(rounds, np.int32)
            k = min(rounds, len(self.arrivals))
            out[:k] = self.arrivals[:k]
            return out
        window = int(np.ceil(self.arrive_frac * rounds))
        out = np.zeros(rounds, np.int32)
        out[:window] = self._rng(seed).poisson(self.rate, size=window)
        return out

    def sample_trace(self, rounds: int, seed: int = 0) -> RequestTrace:
        """The full per-request trace.  Length draws come AFTER the count
        draws from the same stream, so counts alone (``sample_counts``,
        what ``compile`` embeds in extras) are a prefix-consistent view."""
        counts = self.sample_counts(rounds, seed)
        n = int(counts.sum())
        rng = self._rng(seed)
        if self.arrivals is None:
            window = int(np.ceil(self.arrive_frac * rounds))
            rng.poisson(self.rate, size=window)  # replay the count draws
        plen = rng.integers(self.prompt_len[0], self.prompt_len[1] + 1,
                            size=n).astype(np.int32)
        glen = rng.integers(self.gen_len[0], self.gen_len[1] + 1,
                            size=n).astype(np.int32)
        return RequestTrace(
            arrival_round=np.repeat(np.arange(rounds, dtype=np.int32),
                                    counts),
            prompt_len=plen, gen_len=glen)

    def to_dict(self) -> dict:
        return {"rate": self.rate, "prompt_len": list(self.prompt_len),
                "gen_len": list(self.gen_len),
                "arrive_frac": self.arrive_frac,
                "arrivals": None if self.arrivals is None
                else list(self.arrivals)}

    @staticmethod
    def from_dict(d: dict) -> "ServeLoad":
        return ServeLoad(rate=d.get("rate", 1.0),
                         prompt_len=tuple(d.get("prompt_len", (4, 8))),
                         gen_len=tuple(d.get("gen_len", (4, 16))),
                         arrive_frac=d.get("arrive_frac", 0.6),
                         arrivals=None if d.get("arrivals") is None
                         else tuple(d["arrivals"]))


# ---------------------------------------------------- topology serialization

def _topology_to_dict(t: Graph | TopologySchedule) -> dict:
    if isinstance(t, TopologySchedule):
        return {"kind": "phases", **t.to_dict()}
    return {"kind": "graph", **t.to_dict()}


def _topology_from_dict(d: dict) -> Graph | TopologySchedule:
    if d.get("kind") == "phases":
        return TopologySchedule.from_dict(d)
    return Graph.from_dict(d)


# ------------------------------------------------------------------ segments

@dataclasses.dataclass(frozen=True)
class _Segment:
    """One compiled slice of the timeline: a graph held for ``rounds`` with
    a constant active mask, starting at absolute round ``start`` and sampled
    with seed offset ``seed_offset``."""

    graph: Graph
    rounds: int
    start: int
    active: np.ndarray | None  # (n,) bool or None = all alive
    seed_offset: int


# --------------------------------------------------------------------- world

@dataclasses.dataclass(frozen=True)
class World:
    """A declarative, serializable scenario: topology + worker model + link
    model + fault processes.  ``compile(rounds, seed)`` lowers it to one
    ``events.Schedule`` consumed unchanged by both replay paths."""

    topology: Graph | TopologySchedule
    workers: WorkerModel = WorkerModel()
    links: LinkModel = LinkModel()
    faults: tuple = ()
    channel: ChannelModel | None = None
    comms_per_grad: float = 1.0
    jitter_grad_times: bool = True
    t_offset: float = 0.0
    defense: AdaptiveDefense | None = None
    # algorithm zoo (DESIGN.md §13): None = no declared algorithm (the
    # schedule is compiled as without one; dynamics chosen by the caller),
    # an Algorithm spec otherwise — its clock structure lowers into the
    # schedule here, its dynamics column via ``algorithm_params()``
    algorithm: Algorithm | None = None
    # serving workload (DESIGN.md §14): None = training-only world; a
    # ServeLoad attaches per-round request-arrival counts as
    # ``extras[SERVE_ARRIVE_KEY]`` for a gossip-serving fleet
    serve: "ServeLoad | None" = None
    # flight recorder: None = no telemetry (the replay unchanged, bit for
    # bit); a telemetry.Telemetry spec makes the replay emit per-round
    # metric columns as ``trace.telemetry`` without changing any number
    telemetry: "Telemetry | None" = None

    def __post_init__(self):
        if not isinstance(self.topology, (Graph, TopologySchedule)):
            raise ValueError("topology must be a Graph or TopologySchedule, "
                             f"got {type(self.topology).__name__}")
        if not isinstance(self.workers, WorkerModel):
            raise ValueError("workers must be a WorkerModel, "
                             f"got {type(self.workers).__name__}")
        if not isinstance(self.links, LinkModel):
            raise ValueError("links must be a LinkModel, "
                             f"got {type(self.links).__name__}")
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, (ChurnProcess, PhaseSwitch)):
                raise ValueError("faults must be ChurnProcess/PhaseSwitch "
                                 f"instances, got {type(f).__name__}")
            if isinstance(f, ChurnProcess) and f.workers is not None:
                bad = [w for w in f.workers if not 0 <= w < self.topology.n]
                if bad:
                    raise ValueError(
                        f"ChurnProcess.workers entries {bad} outside "
                        f"[0, {self.topology.n}) for this topology")
        if not (np.isfinite(self.comms_per_grad)
                and self.comms_per_grad >= 0):
            raise ValueError(f"comms_per_grad must be >= 0, "
                             f"got {self.comms_per_grad}")
        n = self.n
        if self.workers.grad_rates is not None \
                and len(self.workers.grad_rates) != n:
            raise ValueError(
                f"workers.grad_rates must have shape ({n},) = (n_workers,) "
                f"for this topology, got ({len(self.workers.grad_rates)},)")
        if self.workers.active is not None \
                and len(self.workers.active) != n:
            raise ValueError(
                f"workers.active must have shape ({n},) = (n_workers,) "
                f"for this topology, got ({len(self.workers.active)},)")
        switches = [f for f in self.faults if isinstance(f, PhaseSwitch)]
        if switches and isinstance(self.topology, TopologySchedule):
            raise ValueError("PhaseSwitch faults require a static Graph "
                             "topology; a TopologySchedule already encodes "
                             "its own phases")
        ats = [s.at_round for s in switches]
        if ats != sorted(set(ats)):
            raise ValueError("PhaseSwitch.at_round values must be strictly "
                             f"increasing, got {ats}")
        for s in switches:
            if s.topology is not None and s.topology.n != n:
                raise ValueError(
                    f"PhaseSwitch topology must keep n={n} workers, "
                    f"got n={s.topology.n}")
            if s.active is not None and len(s.active) != n:
                raise ValueError(
                    f"PhaseSwitch.active must have shape ({n},) = "
                    f"(n_workers,), got ({len(s.active)},)")
        multi_graph = isinstance(self.topology, TopologySchedule) or any(
            s.topology is not None for s in switches)
        if multi_graph and (self.links.rates is not None or isinstance(
                self.links.bandwidth_bytes_per_s, tuple)):
            raise ValueError(
                "per-edge links.rates/bandwidth need a single static "
                "topology (edge lists differ across phases) — give each "
                "phase graph its own rates via Graph.with_rates, or use a "
                "scalar bandwidth")
        # eagerly validate per-edge alignment against the static topology
        if isinstance(self.topology, Graph):
            self.links.edge_rates(self.topology)
        if self.channel is not None:
            if not isinstance(self.channel, ChannelModel):
                raise ValueError("channel must be a ChannelModel, "
                                 f"got {type(self.channel).__name__}")
            # adversary edges must exist somewhere in the world's topology
            graphs = list(p.graph for p in self.topology.phases) \
                if isinstance(self.topology, TopologySchedule) \
                else [self.topology]
            graphs += [s.topology for s in switches
                       if s.topology is not None]
            self.channel.validate_for(
                n, [frozenset((min(i, j), max(i, j)) for i, j in g.edges)
                    for g in graphs])
        if self.defense is not None and not isinstance(self.defense,
                                                       AdaptiveDefense):
            raise ValueError("defense must be an AdaptiveDefense, "
                             f"got {type(self.defense).__name__}")
        if self.algorithm is not None and not isinstance(self.algorithm,
                                                         Algorithm):
            raise ValueError("algorithm must be an Algorithm, "
                             f"got {type(self.algorithm).__name__}")
        if self.serve is not None and not isinstance(self.serve, ServeLoad):
            raise ValueError("serve must be a ServeLoad, "
                             f"got {type(self.serve).__name__}")
        if self.telemetry is not None and not isinstance(self.telemetry,
                                                         Telemetry):
            raise ValueError("telemetry must be a telemetry.Telemetry, "
                             f"got {type(self.telemetry).__name__}")

    # ------------------------------------------------------------ structure
    @property
    def n(self) -> int:
        return self.topology.n

    def _base_phases(self, rounds: int | None
                     ) -> list[tuple[Graph, int, np.ndarray | None]]:
        """(graph, rounds, active) triples from topology + PhaseSwitch
        faults, before churn processes cut the timeline further."""
        base_active = self.workers.active_arr()

        def combine(a, b):
            if a is None:
                return None if b is None else b.copy()
            return a.copy() if b is None else (a & b)

        if isinstance(self.topology, TopologySchedule):
            if rounds is not None and rounds != self.topology.total_rounds:
                raise ValueError(
                    f"rounds={rounds} does not match the TopologySchedule's "
                    f"total of {self.topology.total_rounds}; pass rounds=None"
                    " to use the schedule's own duration")
            return [(p.graph, p.rounds,
                     combine(base_active,
                             None if p.active is None else p.active_mask()))
                    for p in self.topology.phases]
        if rounds is None:
            raise ValueError("a World with a static Graph topology needs "
                             "compile(rounds=...)")
        switches = sorted((f for f in self.faults
                           if isinstance(f, PhaseSwitch)),
                          key=lambda s: s.at_round)
        cuts = [0] + [s.at_round for s in switches if s.at_round < rounds] \
            + [rounds]
        out = []
        graph = self.topology
        active = base_active
        live = [s for s in switches if s.at_round < rounds]
        for i in range(len(cuts) - 1):
            if i > 0:
                sw = live[i - 1]
                if sw.topology is not None:
                    graph = sw.topology
                active = combine(base_active,
                                 None if sw.active is None
                                 else np.asarray(sw.active, bool))
            if cuts[i + 1] > cuts[i]:
                out.append((graph, cuts[i + 1] - cuts[i], active))
        return out

    def segments(self, rounds: int | None = None, seed: int = 0
                 ) -> list[_Segment]:
        """The fully-resolved compilation plan: phases cut at every
        ChurnProcess aliveness change, with per-segment seeds and starts."""
        phases = self._base_phases(rounds)
        total = sum(r for _, r, _ in phases)
        churns = [f for f in self.faults if isinstance(f, ChurnProcess)]
        churn_alive = None
        for i, c in enumerate(churns):
            a = c.sample_alive(total, self.n, seed + i)
            churn_alive = a if churn_alive is None else (churn_alive & a)

        segs: list[_Segment] = []
        start = 0
        for graph, ph_rounds, ph_active in phases:
            if churn_alive is None:
                segs.append(_Segment(graph, ph_rounds, start, ph_active,
                                     len(segs)))
            else:
                rows = churn_alive[start:start + ph_rounds]
                if ph_active is not None:
                    rows = rows & ph_active[None, :]
                r0 = 0
                for r in range(1, ph_rounds + 1):
                    if r == ph_rounds or not np.array_equal(rows[r],
                                                            rows[r0]):
                        act = None if rows[r0].all() else rows[r0]
                        segs.append(_Segment(graph, r - r0, start + r0,
                                             act, len(segs)))
                        r0 = r
            start += ph_rounds
        return segs

    def phase_plan(self, rounds: int | None = None, seed: int = 0
                   ) -> TopologySchedule:
        """The compiled segment structure as a TopologySchedule (for chi
        inspection, per-phase matching banks, reporting)."""
        return TopologySchedule(tuple(
            TopologyPhase(s.graph, s.rounds,
                          None if s.active is None else tuple(s.active))
            for s in self.segments(rounds, seed)))

    def segment_graphs(self, rounds: int | None = None, seed: int = 0
                       ) -> list[Graph]:
        """Per-segment *effective* communication graphs: link-model rates
        applied, detached workers isolated (what matching banks consume)."""
        out = []
        for s in self.segments(rounds, seed):
            g = s.graph
            er = self.links.edge_rates(g)
            if er is not None:
                g = g.with_rates(er)
            if s.active is not None and not s.active.all():
                g = g.subgraph(s.active)
            out.append(g)
        return out

    def static_graph(self) -> Graph:
        """The single effective graph of a static (fault-free, fully-attached
        Graph) world — what the mesh trainers derive A²CiD² parameters and
        matching banks from.  Raises for phased/churned worlds: a detached
        worker would sit as an isolated node, making chi1 infinite and the
        derived mixing parameters degenerate (DESIGN.md §8)."""
        a = self.workers.active_arr()
        if not isinstance(self.topology, Graph) or self.faults \
                or (a is not None and not a.all()):
            raise ValueError(
                "static_graph needs a fault-free Graph-topology world with "
                "all workers attached (chi of a world with detached workers "
                "is only defined per phase) — use segment_graphs()/"
                "phase_plan() and gossip.phase_banks/world_banks")
        g = self.topology
        er = self.links.edge_rates(g)
        if er is not None:
            g = g.with_rates(er)
        return g

    def algorithm_params(self, accelerated: bool | None = None):
        """The world's scalar dynamics column — what rides the batched
        replay's per-world (B,) arrays (``Simulator.world_params``).

        Resolves ``algorithm`` (default ``Algorithm()`` = canonical A²CiD²)
        against ``static_graph()``'s chi values; ``accelerated`` overrides
        the arm (the benchmarks' base/accelerated sweep axis).  Needs a
        static world — chi of a phased/churned world is only defined per
        phase (see ``static_graph``).
        """
        algo = self.algorithm if self.algorithm is not None else Algorithm()
        if accelerated is not None:
            algo = dataclasses.replace(algo, accelerated=bool(accelerated))
        return algo.params_for(self.static_graph())

    # -------------------------------------------------------------- compile
    def compile(self, rounds: int | None = None, seed: int = 0):
        """Lower the world to ONE ``events.Schedule``.

        Bit-for-bit contract: a World mirroring ``make_schedule`` /
        ``make_topology_schedule`` kwargs produces the identical schedule
        under the same seed (those entry points are now wrappers over this).
        """
        from .events import _sample_schedule, concat_schedules

        grad_rates = self.workers.grad_rates_arr()
        comm_ctrl = self.defense is not None \
            and self.defense.has_comm_control
        # the algorithm's independent gossip clock (DADAO) replaces
        # comms_per_grad as the comm-event intensity; coupled algorithms
        # pass it through unchanged, keeping the compile bitwise-identical
        cpg = self.comms_per_grad if self.algorithm is None \
            else self.algorithm.comm_rate(self.comms_per_grad)
        # with the comm controller on, sample at the controller's CEILING
        # rate; the controller thins each round down to its keep-fraction
        rate = cpg * (self.defense.comm_hi if comm_ctrl else 1.0)
        scheds = []
        for s in self.segments(rounds, seed):
            scheds.append(_sample_schedule(
                s.graph, s.rounds, rate,
                seed=seed + s.seed_offset,
                jitter_grad_times=self.jitter_grad_times,
                grad_rates=grad_rates,
                edge_rates=self.links.edge_rates(s.graph),
                per_edge=self.links.per_edge,
                t_offset=self.t_offset + float(s.start),
                active=s.active))
        sched = concat_schedules(scheds)
        if self.algorithm is not None:
            # decoupled gradient clock (DADAO): Bernoulli tick thinning on
            # the final concatenated schedule, drawn from the algorithm's
            # own rng stream — a coupled (unit-rate) algorithm returns the
            # schedule bitwise unchanged
            sched = self.algorithm.apply_grad_clock(sched, seed=seed)
        if self.channel is not None:
            # the channel rides on the FINAL concatenated schedule (its
            # staleness caps need absolute round indices), drawing from its
            # own rng stream — a trivial channel is an exact no-op
            sched = self.channel.apply(sched, seed=seed)
        if comm_ctrl:
            # the controller thins AFTER the channel: its degradation
            # score reads the channel extras, and gated slots zero them
            sched = self.defense.apply_comm_control(sched)
        if self.serve is not None:
            # arrivals ride LAST so comm-control thinning (which zeroes
            # gated slots' extras) can't erase workload data; counts sit
            # at event slot 0 (kmax >= 1 always) of every round
            counts = self.serve.sample_counts(sched.rounds, seed)
            arrive = np.zeros(sched.partners.shape[:2], np.float32)
            arrive[:, 0] = counts
            sched = sched.with_extras(**{SERVE_ARRIVE_KEY: arrive})
        return sched

    def round_seconds(self, schedule) -> np.ndarray:
        """(R,) wall seconds per round of a schedule this world compiled,
        applying each phase's own graph to the link model (phase switches
        change the edge set mid-run; churn cuts don't — detached workers
        simply have no events, so only the graph-per-phase structure
        matters and the result is seed-independent)."""
        rounds = None if isinstance(self.topology, TopologySchedule) \
            else schedule.rounds
        out = np.zeros(schedule.rounds)
        start = 0
        for graph, ph_rounds, _ in self._base_phases(rounds):
            out[start:start + ph_rounds] = self.links.round_seconds(
                schedule, graph, range(start, start + ph_rounds))
            start += ph_rounds
        return out

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"topology": _topology_to_dict(self.topology),
                "workers": self.workers.to_dict(),
                "links": self.links.to_dict(),
                "faults": [f.to_dict() for f in self.faults],
                "channel": None if self.channel is None
                else self.channel.to_dict(),
                "comms_per_grad": self.comms_per_grad,
                "jitter_grad_times": self.jitter_grad_times,
                "t_offset": self.t_offset,
                "defense": None if self.defense is None
                else self.defense.to_dict(),
                "algorithm": None if self.algorithm is None
                else self.algorithm.to_dict(),
                "serve": None if self.serve is None
                else self.serve.to_dict(),
                "telemetry": None if self.telemetry is None
                else self.telemetry.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "World":
        return World(topology=_topology_from_dict(d["topology"]),
                     workers=WorkerModel.from_dict(d.get("workers", {})),
                     links=LinkModel.from_dict(d.get("links", {})),
                     faults=tuple(_fault_from_dict(f)
                                  for f in d.get("faults", ())),
                     channel=None if d.get("channel") is None
                     else ChannelModel.from_dict(d["channel"]),
                     comms_per_grad=d.get("comms_per_grad", 1.0),
                     jitter_grad_times=d.get("jitter_grad_times", True),
                     t_offset=d.get("t_offset", 0.0),
                     defense=None if d.get("defense") is None
                     else AdaptiveDefense.from_dict(d["defense"]),
                     algorithm=None if d.get("algorithm") is None
                     else Algorithm.from_dict(d["algorithm"]),
                     serve=None if d.get("serve") is None
                     else ServeLoad.from_dict(d["serve"]),
                     telemetry=None if d.get("telemetry") is None
                     else Telemetry.from_dict(d["telemetry"]))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "World":
        return World.from_dict(json.loads(s))


# --------------------------------------------------------------------- sweeps

@dataclasses.dataclass(frozen=True)
class WorldSweep:
    """A declarative grid of worlds — the unit the batched replay consumes.

    The paper's claims are sweep-shaped (gain vs. topology, vs. Byzantine
    fraction, vs. staleness horizon); a ``WorldSweep`` names one such grid:
    explicit ``worlds`` (or ``WorldSweep.over(base, field=[...], ...)`` for
    a cartesian product of ``World`` field overrides) crossed with
    ``seeds``.  ``compile(rounds)`` lowers the whole grid host-side to one
    schedule per point — seed-major within each world, so
    ``points()[i]`` names what ``compile()[i]`` replays — ready for
    ``Simulator.run_worlds`` to replay in one batched call (DESIGN.md
    §11).  All worlds must share one worker count; ragged event shapes
    across the grid are the batcher's problem (identity padding), not the
    sweep's.
    """

    worlds: tuple[World, ...]
    seeds: tuple[int, ...] = (0,)

    def __post_init__(self):
        object.__setattr__(self, "worlds", tuple(self.worlds))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.worlds:
            raise ValueError("WorldSweep needs at least one world")
        if not self.seeds:
            raise ValueError("WorldSweep needs at least one seed")
        for i, w in enumerate(self.worlds):
            if not isinstance(w, World):
                raise ValueError(f"worlds[{i}] must be a World, "
                                 f"got {type(w).__name__}")
        n = self.worlds[0].n
        bad = [i for i, w in enumerate(self.worlds) if w.n != n]
        if bad:
            raise ValueError(f"all worlds must share one worker count "
                             f"(worlds[0].n = {n}); worlds {bad} differ")

    @staticmethod
    def over(base: World, seeds=(0,), **axes) -> "WorldSweep":
        """Cartesian product of ``World`` field overrides on ``base``.

        Each keyword names a ``World`` dataclass field (``topology``,
        ``channel``, ``comms_per_grad``, ...) with a sequence of values;
        the grid is built with ``dataclasses.replace`` in the keyword
        order given (last axis fastest), re-validating every point.
        """
        fields = {f.name for f in dataclasses.fields(World)}
        bad = sorted(set(axes) - fields)
        if bad:
            raise ValueError(f"unknown World field(s) {bad}; sweep axes "
                             f"must name one of {sorted(fields)}")
        if not axes:
            return WorldSweep((base,), seeds=tuple(seeds))
        names = list(axes)
        worlds = tuple(
            dataclasses.replace(base, **dict(zip(names, values)))
            for values in itertools.product(*[list(axes[k])
                                              for k in names]))
        return WorldSweep(worlds, seeds=tuple(seeds))

    @property
    def n(self) -> int:
        return self.worlds[0].n

    @property
    def size(self) -> int:
        return len(self.worlds) * len(self.seeds)

    def points(self) -> list[tuple[World, int]]:
        """The flattened (world, seed) grid, seed-major within a world."""
        return [(w, s) for w in self.worlds for s in self.seeds]

    def compile(self, rounds: int | None = None) -> list:
        """One ``events.Schedule`` per grid point (host-side; the whole
        grid is plain numpy event data before any replay runs)."""
        return [w.compile(rounds, seed=s) for w, s in self.points()]

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"worlds": [w.to_dict() for w in self.worlds],
                "seeds": list(self.seeds)}

    @staticmethod
    def from_dict(d: dict) -> "WorldSweep":
        return WorldSweep(tuple(World.from_dict(w) for w in d["worlds"]),
                          seeds=tuple(d.get("seeds", (0,))))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "WorldSweep":
        return WorldSweep.from_dict(json.loads(s))


# --------------------------------------------------------------------------
# Shard-aware schedule compilation, schedule-level half.  The stream-level
# partition lives in events.shard_partition; these two operate on compiled
# Schedules, the form tests and telemetry consume.
# --------------------------------------------------------------------------

def shard_cross_reads(sched, n_shards: int) -> np.ndarray:
    """(R,) per-round cross-shard boundary-read counts of a compiled
    schedule under an ``n_shards``-way equal split of the worker axis: the
    host-side exact column behind the telemetry ``bytes_cross`` split
    (boundary rows x flat-row width).  Zeros when the worker axis does not
    divide evenly (the replay falls back to one device, so nothing crosses
    a boundary)."""
    from .telemetry import cross_shard_reads

    return cross_shard_reads(sched.partners, sched.event_mask, n_shards)


def shard_lag_schedule(sched, n_shards: int, lag: int):
    """The per-event delay reference of a lag-``lag`` sharded replay: the
    same schedule with every cross-shard read's staleness floored at
    ``lag`` (clamped to rounds elapsed, the ``ChannelModel`` guarantee).

    ``Simulator.run_worlds(mesh=MeshReplay(mesh, lag=L))`` on ``sched`` is
    bit for bit the single-device replay of ``shard_lag_schedule(sched,
    NS, L)``: the permute ring is exactly a ``DelayProcess`` whose floor is
    the ring lag on boundary edges.
    """
    from .channel import STALE_KEY

    partners = np.asarray(sched.partners)
    R, K, n = partners.shape
    if lag <= 0 or n_shards <= 1:
        return sched
    if n % n_shards != 0:
        raise ValueError(f"worker axis {n} is not divisible by "
                         f"{n_shards} shards")
    ws = n // n_shards
    rdr = np.arange(n, dtype=np.int64)
    cross = ((partners != rdr)
             & (partners.astype(np.int64) // ws != rdr // ws)
             & np.asarray(sched.event_mask)[..., None])
    extras = sched.extras_dict()
    stale = np.asarray(extras.get(STALE_KEY,
                                  np.zeros((R, K, n), np.int32)), np.int64)
    rounds_elapsed = np.arange(R, dtype=np.int64)[:, None, None]
    eff = np.minimum(np.maximum(stale, int(lag)), rounds_elapsed)
    extras[STALE_KEY] = np.where(cross, eff, stale).astype(np.int32)
    return dataclasses.replace(sched, extras=extras)
