"""Unreliable-channel subsystem: stale reads, Byzantine edges, drops.

The paper's asynchronous p2p averaging assumes honest, instantaneous
pairwise exchanges.  A :class:`ChannelModel` describes the opposite regime
declaratively (messages arrive late, links lose packets, some edges are
adversarial):

    ChannelModel(delay=DelayProcess(horizon=4, prob=0.5),
                 adversary=ByzantineEdges(((0, 1), (5, 6)), "sign_flip"),
                 drop_prob=0.02)

and compiles, through ``Schedule.extras``, to per-event arrays the replay
paths consume:

  * ``extras["stale"]``  (R, K, n) int32 — staleness offset of worker i's
    READ at event (r, k): 0 = fresh, s >= 1 = the partner's flat state
    snapshotted at the end of round ``r - s`` (served from a ring of the
    last ``H`` states, rotated at each gradient tick).
  * ``extras["corrupt"]`` (R, K, n) float32 — multiplier OFFSET on the
    received partner value: the replay reads ``(1 + corrupt) * x_p``, so
    zero padding means "honest".  ``sign_flip`` is -2, ``zero`` is -1,
    ``scale`` is ``scale - 1``.
  * message drops rewrite the partner involution itself (the dropped pair
    reverts to identity partners), so a drop needs no replay support.

All channel randomness comes from a dedicated numpy stream
(``SeedSequence([seed, 0xC4A77, substream])``), so a trivial channel leaves
a compiled schedule bit-for-bit identical to the channel-free one.  This is
the port's own copy of the JAX package's numpy module of the same name:
every compiled array is equal to the JAX package's for the same arguments.

The defense against a hostile channel (the trimmed/clipped p2p delta) is a
replay knob (``Simulator(robust_clip=..., robust_rule=...)``), not channel
data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# rng-stream tag for channel draws — independent of the schedule's main
# stream and of the straggler (0x48455) / churn (0xC50C4) streams
_CHANNEL_TAG = 0xC4A77
# Schedule.extras keys the channel compiles to; both replay paths key on
# exactly these names
STALE_KEY = "stale"
CORRUPT_KEY = "corrupt"
# where drops erased a pair (a drop rewrites the partners to identity,
# which the surviving arrays cannot tell from "never scheduled"); host-only
# data that no replay reads
DROP_KEY = "drop"

# corrupt-value multipliers per adversary mode: the receiver sees
# multiplier * x_partner instead of x_partner
_MODE_MULTIPLIER = {"sign_flip": -1.0, "zero": 0.0}


@dataclasses.dataclass(frozen=True)
class DelayProcess:
    """Per-read message staleness.

    Each directed read is independently stale with probability ``prob``; a
    stale read returns the partner's flat state snapshotted ``s`` rounds
    ago, with ``s`` ~ Uniform{1..horizon} (``"uniform"``) or ``s =
    horizon`` (``"fixed"``).  Offsets are clamped to the rounds elapsed, so
    the ring is never read before it is written.  ``horizon=0`` disables
    delay entirely.
    """

    horizon: int
    prob: float = 1.0
    kind: str = "uniform"

    def __post_init__(self):
        if not isinstance(self.horizon, (int, np.integer)) \
                or isinstance(self.horizon, bool) or self.horizon < 0:
            raise ValueError("DelayProcess.horizon must be an int >= 0, "
                             f"got {self.horizon!r}")
        object.__setattr__(self, "horizon", int(self.horizon))
        if not (np.isfinite(self.prob) and 0.0 <= self.prob <= 1.0):
            raise ValueError(f"DelayProcess.prob must lie in [0, 1], "
                             f"got {self.prob}")
        if self.kind not in ("uniform", "fixed"):
            raise ValueError("DelayProcess.kind must be 'uniform' or "
                             f"'fixed', got {self.kind!r}")

    @property
    def is_trivial(self) -> bool:
        return self.horizon == 0 or self.prob == 0.0

    def sample_offsets(self, shape, rng: np.random.Generator) -> np.ndarray:
        """Raw (unclamped) staleness draws; 0 where the read is fresh."""
        hit = rng.uniform(size=shape) < self.prob
        if self.kind == "fixed":
            offs = np.full(shape, self.horizon, np.int32)
        else:
            offs = rng.integers(1, self.horizon + 1, size=shape,
                                dtype=np.int32)
        return np.where(hit, offs, 0).astype(np.int32)

    def to_dict(self) -> dict:
        return {"horizon": self.horizon, "prob": self.prob,
                "kind": self.kind}

    @staticmethod
    def from_dict(d: dict) -> "DelayProcess":
        return DelayProcess(horizon=d["horizon"], prob=d.get("prob", 1.0),
                            kind=d.get("kind", "uniform"))


@dataclasses.dataclass(frozen=True)
class ByzantineEdges:
    """Adversarial partners on a fixed subset of edges.

    A message crossing a listed edge is corrupted, with duty cycle ``prob``
    per exchange (both directions share one draw: the fault sits on the
    link): ``"sign_flip"`` (the receiver sees ``-x_partner``), ``"zero"``
    (``0``) or ``"scale"`` (``scale * x_partner``, garbage injection).
    Corruption is a property of the edge, not the worker: the endpoints
    still send their true state on their other edges.
    """

    edges: tuple[tuple[int, int], ...]
    mode: str = "sign_flip"
    scale: float = 1.0
    prob: float = 1.0

    def __post_init__(self):
        try:
            edges = tuple((int(i), int(j)) for i, j in self.edges)
        except (TypeError, ValueError):
            raise ValueError("ByzantineEdges.edges must be (i, j) pairs, "
                             f"got {self.edges!r}") from None
        if not edges:
            raise ValueError("ByzantineEdges.edges must be non-empty — an "
                             "edgeless adversary is ChannelModel(adversary="
                             "None)")
        for (i, j) in edges:
            if i == j or i < 0 or j < 0:
                raise ValueError("ByzantineEdges.edges entries must pair two "
                                 f"distinct workers, got ({i}, {j})")
        object.__setattr__(
            self, "edges", tuple((min(i, j), max(i, j)) for i, j in edges))
        if self.mode not in ("sign_flip", "zero", "scale"):
            raise ValueError("ByzantineEdges.mode must be 'sign_flip', "
                             f"'zero', or 'scale', got {self.mode!r}")
        if not np.isfinite(self.scale):
            raise ValueError(f"ByzantineEdges.scale must be finite, "
                             f"got {self.scale}")
        if not (np.isfinite(self.prob) and 0.0 < self.prob <= 1.0):
            raise ValueError(f"ByzantineEdges.prob must lie in (0, 1], "
                             f"got {self.prob}")

    def multiplier(self) -> float:
        """The received-value multiplier this mode applies."""
        return _MODE_MULTIPLIER.get(self.mode, self.scale)

    def corrupt_offset(self) -> float:
        """Multiplier offset stored in ``extras["corrupt"]`` (honest = 0)."""
        return self.multiplier() - 1.0

    def edge_set(self) -> frozenset:
        return frozenset(self.edges)

    def lookup(self, n: int) -> np.ndarray:
        """(n, n) bool adjacency of the Byzantine edge set."""
        out = np.zeros((n, n), dtype=bool)
        for (i, j) in self.edges:
            if j >= n:
                raise ValueError(f"ByzantineEdges edge ({i}, {j}) names a "
                                 f"worker outside [0, {n})")
            out[i, j] = out[j, i] = True
        return out

    def to_dict(self) -> dict:
        return {"edges": [list(e) for e in self.edges], "mode": self.mode,
                "scale": self.scale, "prob": self.prob}

    @staticmethod
    def from_dict(d: dict) -> "ByzantineEdges":
        return ByzantineEdges(edges=tuple((int(i), int(j))
                                          for i, j in d["edges"]),
                              mode=d.get("mode", "sign_flip"),
                              scale=d.get("scale", 1.0),
                              prob=d.get("prob", 1.0))


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Declarative unreliable-channel model: delay + adversary + drops.

    ``apply(schedule, seed)`` compiles the channel onto an already-sampled
    event schedule.  A trivial channel returns the schedule object
    unchanged — the exact-reduction contract.
    """

    delay: DelayProcess | None = None
    adversary: ByzantineEdges | None = None
    drop_prob: float = 0.0

    def __post_init__(self):
        if self.delay is not None and not isinstance(self.delay,
                                                     DelayProcess):
            raise ValueError("channel.delay must be a DelayProcess, "
                             f"got {type(self.delay).__name__}")
        if self.adversary is not None and not isinstance(self.adversary,
                                                         ByzantineEdges):
            raise ValueError("channel.adversary must be ByzantineEdges, "
                             f"got {type(self.adversary).__name__}")
        if not (np.isfinite(self.drop_prob)
                and 0.0 <= self.drop_prob < 1.0):
            raise ValueError(f"channel.drop_prob must lie in [0, 1), "
                             f"got {self.drop_prob}")

    @property
    def is_trivial(self) -> bool:
        return ((self.delay is None or self.delay.is_trivial)
                and self.adversary is None and self.drop_prob == 0.0)

    @property
    def horizon(self) -> int:
        """Ring-buffer depth the replay needs for this channel."""
        if self.delay is None or self.delay.is_trivial:
            return 0
        return self.delay.horizon

    def validate_for(self, n: int, edge_sets=()) -> None:
        """Check adversary edges against a world: worker ids in [0, n) and,
        when candidate edge sets are known, membership in at least one."""
        if self.adversary is None:
            return
        self.adversary.lookup(n)  # id range check
        sets = [s for s in edge_sets if s]
        if sets:
            known = frozenset().union(*sets)
            missing = sorted(e for e in self.adversary.edges
                             if e not in known)
            if missing:
                raise ValueError(
                    f"channel.adversary edges {missing} are not edges of "
                    "this world's topology (an adversary needs a link to "
                    "corrupt)")

    def apply(self, schedule, seed: int = 0):
        """Compile the channel onto one ``events.Schedule``: drops first (a
        dropped message is neither stale nor corrupted), then the
        ``stale``/``corrupt`` extras over the surviving pairs, each axis
        from its own substream of the channel's rng stream."""
        if self.is_trivial:
            return schedule
        partners = schedule.partners
        R, K, n = partners.shape
        idx = np.arange(n)

        def pair_anchor(p):
            """True at (r, k, i) iff p[r, k, i] = j > i on an unmasked
            event: each pair keyed once, so both endpoints share a draw."""
            return (p > idx) & schedule.event_mask[:, :, None]

        extras = {}
        if self.drop_prob > 0.0:
            rng = np.random.default_rng(
                np.random.SeedSequence([int(seed), _CHANNEL_TAG, 0]))
            partners = partners.copy()
            u = rng.uniform(size=(R, K, n))
            rr, kk, ii = np.nonzero(pair_anchor(partners)
                                    & (u < self.drop_prob))
            jj = partners[rr, kk, ii]
            partners[rr, kk, ii] = ii
            partners[rr, kk, jj.astype(np.intp)] = jj
            dropped = np.zeros((R, K, n), np.int32)
            dropped[rr, kk, ii] = 1
            dropped[rr, kk, jj.astype(np.intp)] = 1
            extras[DROP_KEY] = dropped

        involved = (partners != idx) & schedule.event_mask[:, :, None]
        if self.delay is not None and not self.delay.is_trivial:
            rng = np.random.default_rng(
                np.random.SeedSequence([int(seed), _CHANNEL_TAG, 1]))
            offs = self.delay.sample_offsets((R, K, n), rng)
            # round r has only r past snapshots; the ring holds horizon
            cap = np.minimum(np.arange(R), self.delay.horizon)
            offs = np.minimum(offs, cap[:, None, None])
            extras[STALE_KEY] = np.where(involved, offs, 0).astype(np.int32)
        if self.adversary is not None:
            byz = self.adversary.lookup(n)
            hit = involved & byz[np.broadcast_to(idx, (R, K, n)), partners]
            if self.adversary.prob < 1.0:
                # intermittent fault: one duty-cycle draw per EXCHANGE
                rng = np.random.default_rng(
                    np.random.SeedSequence([int(seed), _CHANNEL_TAG, 2]))
                u = rng.uniform(size=(R, K, n))
                rr, kk, ii = np.nonzero(hit & pair_anchor(partners)
                                        & (u >= self.adversary.prob))
                jj = partners[rr, kk, ii]
                hit[rr, kk, ii] = False
                hit[rr, kk, jj.astype(np.intp)] = False
            extras[CORRUPT_KEY] = np.where(
                hit, np.float32(self.adversary.corrupt_offset()),
                np.float32(0.0))

        out = schedule
        if partners is not schedule.partners:
            out = dataclasses.replace(out, partners=partners)
        return out.with_extras(**extras) if extras else out

    def to_dict(self) -> dict:
        return {"delay": None if self.delay is None else self.delay.to_dict(),
                "adversary": None if self.adversary is None
                else self.adversary.to_dict(),
                "drop_prob": self.drop_prob}

    @staticmethod
    def from_dict(d: dict) -> "ChannelModel":
        delay = d.get("delay")
        adversary = d.get("adversary")
        return ChannelModel(
            delay=None if delay is None else DelayProcess.from_dict(delay),
            adversary=None if adversary is None
            else ByzantineEdges.from_dict(adversary),
            drop_prob=d.get("drop_prob", 0.0))


def has_channel_extras(schedule) -> bool:
    """True iff a schedule (or coalesced schedule / event stream) carries
    channel extras the replay paths must honor."""
    extras = schedule.extras or {}
    return STALE_KEY in extras or CORRUPT_KEY in extras


def degradation_profile(schedule) -> np.ndarray:
    """(R,) per-round channel-degradation score: the fraction of involved
    partner reads that are stale or corrupted (0 for rounds with no
    involved reads).  The defense's comm controller derates by it."""
    R, K, n = schedule.partners.shape
    idx = np.arange(n)
    involved = (schedule.partners != idx) & schedule.event_mask[:, :, None]
    extras = schedule.extras_dict()
    bad = np.zeros((R, K, n), bool)
    stale = extras.get(STALE_KEY)
    if stale is not None:
        bad |= np.asarray(stale) > 0
    corrupt = extras.get(CORRUPT_KEY)
    if corrupt is not None:
        bad |= np.asarray(corrupt) != 0
    num = (bad & involved).reshape(R, -1).sum(axis=1)
    den = np.maximum(involved.reshape(R, -1).sum(axis=1), 1)
    return (num / den).astype(np.float32)
