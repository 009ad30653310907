"""Self-healing gossip defense: the robust m-term as per-round feedback.

A static ``robust_clip`` picks one tau for the whole replay, which cannot
separate a sign-flip adversary (delta norm ``||x + xp|| ~ 2||x||``) from
honest traffic while the workers are far from consensus.  This module
closes the loop with three controllers, configured as
``AdaptiveDefense(...)`` and exact no-ops when off:

  * adaptive tau — ``tau_r = q * qest``, with ``qest`` an EMA of a quantile
    of the admitted (non-gross, non-quarantined) delta norms, updated once
    per round at the gradient tick; cold start uses ``min(tau0, static
    tau)`` until the first admitted norms seed the estimator;
  * edge trust + quarantine — per directed edge an EMA trust score pulled
    toward 1 by accepted exchanges and toward 0 by GROSS violations
    (``nrm > margin * tau``); below ``trust_floor`` the edge is
    quarantined (mscale 0) while its trust heals at rate ``heal``;
  * degradation-aware comm control — a host-side schedule transform that
    thins each round's matchings to a keep-fraction ramping from
    ``comm_lo``/``comm_hi`` up, derated by the round's channel degradation.

The in-loop state (``DefenseState``) and knobs (``DefenseKnobs``) are
NamedTuples of f32 tensors on the replay's device, updated without any
host synchronisation.  NEUTRAL knobs (adapt 0, rho 0, floor -1) reproduce
the static trim arithmetic bitwise: ``mscale = (nrm <= tau)``.

This is the port of the JAX package's module of the same name; the host
half is the same numpy code, the device half the same f32 arithmetic on
tensors.  The device functions take an optional leading world axis: the
world-batched replay passes knobs of (B,) columns (``knobs_worlds``), a
(B, n, n) trust table and (B, n) rows, where the JAX package vmaps the
serial functions; row b is then world b's serial update.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdaptiveDefense:
    """Declarative self-healing defense spec.

    adaptive_tau — enable the quantile-tracking threshold; ``q`` is the
      multiplier on the quantile estimate, ``quantile`` the tracked order
      statistic of admitted norms, ``beta`` the estimator's EMA rate,
      ``tau0`` the cold-start threshold (the effective cold tau is
      min(tau0, static tau)).
    trust — enable edge trust/quarantine; ``rho`` the trust EMA rate,
      ``trust_floor`` the quarantine threshold, ``heal`` the probation
      re-admission rate, ``margin`` the conviction margin (trust is only
      damaged by nrm > margin * tau; borderline rejections never convict).
    comm_lo/comm_hi/comm_degrade — the host-side communication controller;
      all three at their defaults = controller off.
    """

    adaptive_tau: bool = True
    q: float = 3.0
    quantile: float = 0.75
    beta: float = 0.2
    tau0: float = float("inf")
    trust: bool = True
    rho: float = 0.25
    trust_floor: float = 0.25
    heal: float = 0.02
    margin: float = 3.0
    comm_lo: float = 1.0
    comm_hi: float = 1.0
    comm_degrade: float = 0.0

    def __post_init__(self):
        if not self.q > 0:
            raise ValueError(f"q must be > 0, got {self.q}")
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got "
                             f"{self.quantile}")
        if not 0.0 < self.beta <= 1.0:
            raise ValueError(f"beta must be in (0, 1], got {self.beta}")
        if not self.tau0 > 0:
            raise ValueError(f"tau0 must be > 0, got {self.tau0}")
        if not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [0, 1], got {self.rho}")
        if not self.trust_floor < 1.0:
            raise ValueError(f"trust_floor must be < 1, got "
                             f"{self.trust_floor}")
        if not 0.0 <= self.heal <= 1.0:
            raise ValueError(f"heal must be in [0, 1], got {self.heal}")
        if not self.margin >= 1.0:
            raise ValueError(f"margin must be >= 1, got {self.margin}")
        if not 0.0 < self.comm_lo <= self.comm_hi:
            raise ValueError("need 0 < comm_lo <= comm_hi, got "
                             f"({self.comm_lo}, {self.comm_hi})")
        if self.comm_degrade < 0:
            raise ValueError(f"comm_degrade must be >= 0, got "
                             f"{self.comm_degrade}")

    @property
    def is_active(self) -> bool:
        """True when the in-loop controller must run (adaptive tau or
        trust); the comm controller alone is a schedule transform."""
        return self.adaptive_tau or self.trust

    @property
    def has_comm_control(self) -> bool:
        return (self.comm_lo != 1.0 or self.comm_hi != 1.0
                or self.comm_degrade != 0.0)

    # ------------------------------------------------- comm controller
    def comm_multipliers(self, rounds: int,
                         degradation: np.ndarray) -> np.ndarray:
        """(R,) keep-fraction per round: a comm_lo -> comm_hi ramp over
        the replay, derated by the channel-degradation score."""
        prog = (np.arange(rounds, dtype=np.float64) + 1.0) / max(rounds, 1)
        ramp = self.comm_lo + (self.comm_hi - self.comm_lo) * prog
        derate = np.clip(1.0 - self.comm_degrade
                         * np.asarray(degradation, np.float64), 0.0, 1.0)
        return np.clip(ramp * derate / self.comm_hi, 0.0, 1.0)

    def apply_comm_control(self, schedule):
        """Thin a compiled schedule to the controller's per-round rate:
        keep the first ceil(frac_r * K_active) active matchings of round r
        and gate the rest (identity partners, masked, extras zeroed — an
        exact no-op on every replay path)."""
        if not self.has_comm_control:
            return schedule
        from .channel import degradation_profile
        frac = self.comm_multipliers(schedule.rounds,
                                     degradation_profile(schedule))
        partners = np.array(schedule.partners)
        mask = np.array(schedule.event_mask)
        extras = {k: np.array(v) for k, v in schedule.extras_dict().items()}
        R, K, n = partners.shape
        idx = np.arange(n, dtype=partners.dtype)
        for r in range(R):
            active = np.flatnonzero(mask[r]
                                    & (partners[r] != idx).any(axis=1))
            keep = int(math.ceil(frac[r] * active.size))
            for k in active[keep:]:
                partners[r, k] = idx
                mask[r, k] = False
                for a in extras.values():
                    a[r, k] = 0
        out = dataclasses.replace(schedule, partners=partners,
                                  event_mask=mask)
        return out.with_extras(**extras) if extras else out

    # ------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # JSON has no inf literal; None round-trips to the default
        if math.isinf(d["tau0"]):
            d["tau0"] = None
        return d

    @staticmethod
    def from_dict(d: dict) -> "AdaptiveDefense":
        d = dict(d)
        if d.get("tau0") is None:
            d["tau0"] = float("inf")
        return AdaptiveDefense(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "AdaptiveDefense":
        return AdaptiveDefense.from_dict(json.loads(s))


# ------------------------------------------------------------ device side
# The replay loops never see AdaptiveDefense itself: the spec lowers to
# DefenseKnobs of f32 scalars, so "no defense" is just the NEUTRAL knobs.

class DefenseKnobs(NamedTuple):
    adapt: torch.Tensor   # > 0 enables adaptive tau
    q: torch.Tensor       # tau multiplier on the quantile estimate
    p: torch.Tensor       # tracked quantile of accepted norms
    beta: torch.Tensor    # quantile-estimator EMA rate
    tau0: torch.Tensor    # cold-start tau while the estimator is unseeded
    tau_s: torch.Tensor   # static tau (adapt == 0 arms; inf = accept all)
    rho: torch.Tensor     # trust EMA rate (0 freezes trust)
    floor: torch.Tensor   # quarantine threshold (-1 disables quarantine)
    heal: torch.Tensor    # probation re-admission rate
    margin: torch.Tensor  # conviction margin: trust damage needs nrm > m*tau


class DefenseState(NamedTuple):
    qest: torch.Tensor      # scalar quantile estimate (0 = unseeded)
    trust: torch.Tensor     # (n, n) directed edge trust, init 1
    lastn: torch.Tensor     # (n,) this round's last recorded positive norm
    lastv: torch.Tensor     # (n,) bool: lastn valid
    rej_acc: torch.Tensor   # scalar, norm rejections accumulated this round
    quar_acc: torch.Tensor  # scalar, quarantined exchanges this round


class DefenseTrace(NamedTuple):
    """Per-round control-loop trace riding ``SimTrace.defense``: the tau in
    effect, the norm-rejection count and the quarantined-exchange count,
    each (R,)."""
    tau: torch.Tensor
    rejections: torch.Tensor
    quarantined: torch.Tensor


_NEUTRAL = {"adapt": 0.0, "q": 1.0, "p": 0.5, "beta": 1.0,
            "tau0": float("inf"), "rho": 0.0, "floor": -1.0, "heal": 0.0,
            "margin": 1.0}


def defense_knobs(defense: AdaptiveDefense | None,
                  static_tau: float | None) -> tuple:
    """Lower one (defense, static robust tau) arm to plain knob floats.

    ``defense=None`` (or both loops switched off) lowers to the neutral
    values, under which the loop arithmetic is BITWISE the static path.
    The cold-start tau is never looser than the static threshold.
    """
    tau_s = float("inf") if static_tau is None else float(static_tau)
    if defense is None:
        k = dict(_NEUTRAL)
    else:
        k = {"adapt": 1.0 if defense.adaptive_tau else 0.0,
             "q": defense.q, "p": defense.quantile, "beta": defense.beta,
             "tau0": min(defense.tau0, tau_s),
             "rho": defense.rho if defense.trust else 0.0,
             "floor": defense.trust_floor if defense.trust else -1.0,
             "heal": defense.heal if defense.trust else 0.0,
             "margin": defense.margin}
    return (k["adapt"], k["q"], k["p"], k["beta"], k["tau0"], tau_s,
            k["rho"], k["floor"], k["heal"], k["margin"])


def knobs_single(defense: AdaptiveDefense | None, static_tau: float | None,
                 device) -> DefenseKnobs:
    """Serial-replay knobs: f32 scalar tensors on ``device``."""
    vals = defense_knobs(defense, static_tau)
    return DefenseKnobs(*(torch.tensor(v, dtype=torch.float32,
                                       device=device) for v in vals))


def knobs_worlds(defenses, static_taus, device) -> DefenseKnobs:
    """World-batched knobs: (B,) f32 columns on ``device``, one row per
    (defense, static tau) arm."""
    rows = [defense_knobs(d, t) for d, t in zip(defenses, static_taus)]
    cols = np.asarray(rows, np.float32).T
    return DefenseKnobs(*(torch.from_numpy(c.copy()).to(device)
                          for c in cols))


def defense_init(n: int, device, batch: int | None = None,
                 rows: int | None = None) -> DefenseState:
    """Fresh control-loop state (all trust 1, estimator unseeded), with a
    leading world axis of ``batch`` when given.  ``rows`` (default n) is
    the number of reader rows held here: a shard of the sharded replay
    keeps its own (rows, n) trust table and (rows,) records, while the
    estimator and the round counters are per world."""
    lead = () if batch is None else (batch,)
    rows = n if rows is None else rows

    def full(shape, v, dtype=torch.float32):
        return torch.full(lead + shape, v, dtype=dtype, device=device)

    return DefenseState(qest=full((), 0.0), trust=full((rows, n), 1.0),
                        lastn=full((rows,), 0.0),
                        lastv=full((rows,), False, torch.bool),
                        rej_acc=full((), 0.0), quar_acc=full((), 0.0))


def _row(v: torch.Tensor) -> torch.Tensor:
    """A per-world scalar (0-d serially, (B,) batched) broadcastable
    against that world's (n,) rows."""
    return v.unsqueeze(-1)


def _tau_of(k: DefenseKnobs, ds: DefenseState) -> torch.Tensor:
    """The round's threshold: q * qest once seeded, tau0 while cold, the
    static tau on adapt == 0 arms."""
    return torch.where(k.adapt > 0,
                       torch.where(ds.qest > 0, k.q * ds.qest, k.tau0),
                       k.tau_s)


def defense_comm(k: DefenseKnobs, ds: DefenseState, partner: torch.Tensor,
                 involved: torch.Tensor, nrm: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, DefenseState]:
    """One comm step of the control loop.

    partner/involved/nrm are (n,) per-reader rows (nrm the delta norm of
    the exchange, 0 on idle rows), or (B, n) with a batched state.
    Returns the (n,) f32 mscale for the fused channel kernel, the (n,)
    bool quarantine mask, and the updated state.  The engine applies this
    once per fused batch where the per-event path applies it once per
    event: a batch merges only disjoint matchings, so each reader row and
    its trust entry see at most one event per batch and the row updates
    commute.
    """
    col = partner.long().unsqueeze(-1)   # trust[.., w, partner[w]]
    tau = _row(_tau_of(k, ds))
    accept = nrm <= tau
    tr = ds.trust.gather(-1, col).squeeze(-1)
    quar = (tr < _row(k.floor)) & involved
    mscale = (accept & ~quar).float()
    # trust EMA on involved edges; quarantined edges observe nothing and
    # heal toward re-admission.  Only GROSS violations (beyond margin *
    # tau) count against trust: borderline rejections never convict.
    fine = nrm <= _row(k.margin) * tau
    obs = fine.float()
    rho = _row(k.rho)
    upd = torch.where(quar, tr + _row(k.heal) * (1.0 - tr),
                      (1.0 - rho) * tr + rho * obs)
    trust = ds.trust.scatter(-1, col,
                             torch.where(involved, upd, tr).unsqueeze(-1))
    # the quantile estimator records every admitted non-gross exchange
    # (borderline rejections included, or a tight tau ratchets itself
    # shut); quarantined, gross and idle (nrm 0) reads are excluded
    rec = involved & ~quar & fine & (nrm > 0)
    return mscale, quar, ds._replace(
        trust=trust,
        lastn=torch.where(rec, nrm, ds.lastn),
        lastv=ds.lastv | rec)


def defense_absorb(ds: DefenseState, rej: torch.Tensor, quar: torch.Tensor,
                   involved: torch.Tensor) -> DefenseState:
    """Fold the kernel's per-event rejection mask (mscale == 0) into the
    round counters; quarantine-induced zeros are counted separately."""
    rejn = torch.where(involved & ~quar, rej, 0.0).sum(-1)
    return ds._replace(rej_acc=ds.rej_acc + rejn,
                       quar_acc=ds.quar_acc + quar.float().sum(-1))


def defense_grad(k: DefenseKnobs, ds: DefenseState
                 ) -> tuple[DefenseState, tuple]:
    """The gradient-tick controller update.

    Folds the round's recorded norms into the quantile EMA and resets the
    per-round records.  Returns the new state and the (tau, rejections,
    quarantined) trace row, tau being the threshold IN EFFECT this round.
    Learns only from strictly positive norms, so an all-idle round leaves
    the estimate untouched.
    """
    n = ds.lastn.shape[-1]
    tau = _tau_of(k, ds)
    s = torch.sort(torch.where(ds.lastv, ds.lastn, math.inf), dim=-1).values
    m = ds.lastv.int().sum(-1)
    iq = torch.clamp(torch.ceil(k.p * m.float()).int() - 1, 0, n - 1)
    quant = s.gather(-1, iq.long().unsqueeze(-1)).squeeze(-1)
    upd = (m > 0) & (k.adapt > 0) & torch.isfinite(quant)
    seeded = torch.where(ds.qest > 0,
                         (1.0 - k.beta) * ds.qest + k.beta * quant, quant)
    # pressure valve: a round that rejected exchanges yet recorded nothing
    # means every admitted read was gross — a miscalibrated tau under a
    # minority-Byzantine channel, so grow the estimate by the margin
    starve = (m == 0) & (k.adapt > 0) & (ds.qest > 0) & (ds.rej_acc > 0)
    grown = torch.where(starve, ds.qest * k.margin, ds.qest)
    out = (tau, ds.rej_acc, ds.quar_acc)
    return ds._replace(qest=torch.where(upd, seeded, grown),
                       lastn=torch.zeros_like(ds.lastn),
                       lastv=torch.zeros_like(ds.lastv),
                       rej_acc=torch.zeros_like(ds.rej_acc),
                       quar_acc=torch.zeros_like(ds.quar_acc)), out
