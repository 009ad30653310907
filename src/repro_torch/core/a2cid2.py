"""A2CiD2 continuous momentum — the paper's core contribution (Sec 3.2, Algo 1).

Each worker holds two buffers: the parameters ``x`` and a momentum copy
``x_tilde``.  Between events they follow the mixing ODE

    dx/dt      = eta (x_tilde - x)
    dx_tilde/dt = eta (x - x_tilde)

whose flow is the doubly-stochastic 2x2 matrix

    exp(t*A) = 1/2 [[1+e, 1-e], [1-e, 1+e]],   e = exp(-2 eta t).

Events:
  * gradient event (rate 1 / worker):  x -= gamma*g ; x_tilde -= gamma*g   (Eq 4)
  * p2p event on edge (i,j):  with m = x_i - x_j,
        x_i -= alpha*m ; x_tilde_i -= alpha_t*m

Prop 3.6 hyper-parameters:
  * baseline (no acceleration): eta = 0, alpha = alpha_t = 1/2, chi = chi_1
  * A2CiD2: eta = 1/(2 sqrt(chi1 chi2)), alpha = 1/2,
            alpha_t = 1/2 sqrt(chi1/chi2), chi = sqrt(chi1 chi2)

Update functions work on dict/list/tuple pytrees of tensors (see ``tree``)
and follow the JAX package's order of operations, so the two agree to
rounding of ``exp``.  A Python scalar (alpha, alpha~, gamma) is rounded to
the leaf's dtype before it multiplies the leaf, as JAX binds a weak scalar.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from ..kernels.a2cid2_mixing.ref import dtype_scalar
from .tree import PyTree, tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class A2CiD2Params:
    """Scalar hyper-parameters of the dynamic (Eq 4 / Prop 3.6)."""

    eta: float
    alpha: float
    alpha_tilde: float
    chi: float  # effective chi entering the rate: chi1 (baseline) or sqrt(chi1 chi2)

    @property
    def accelerated(self) -> bool:
        return self.eta > 0.0


def baseline_params(chi1: float) -> A2CiD2Params:
    """The non-accelerated asynchronous baseline (a refined AD-PSGD)."""
    return A2CiD2Params(eta=0.0, alpha=0.5, alpha_tilde=0.5, chi=chi1)


def acid_params(chi1: float, chi2: float) -> A2CiD2Params:
    """Accelerated parameters from Prop 3.6."""
    if not (0.0 < chi2 <= chi1 + 1e-9):
        raise ValueError(f"need 0 < chi2 <= chi1, got chi1={chi1}, chi2={chi2}")
    root = math.sqrt(chi1 * chi2)
    return A2CiD2Params(
        eta=1.0 / (2.0 * root),
        alpha=0.5,
        alpha_tilde=0.5 * math.sqrt(chi1 / chi2),
        chi=root,
    )


def params_from_graph(graph, accelerated: bool = True) -> A2CiD2Params:
    chi1 = graph.chi1()
    if not accelerated:
        return baseline_params(chi1)
    return acid_params(chi1, graph.chi2())


# ------------------------------------------------------------- algorithm zoo

#: Known algorithm kinds and whether their canonical form runs the
#: accelerated (eta > 0) dynamics.  Every kind lowers onto the same replay:
#: per-world dynamics data plus clock structure, never a new engine.
#:   a2cid2  — the paper's dynamic (Prop 3.6), coupled unit-rate clocks
#:   adpsgd  — the asynchronous baseline (eta = 0, alpha = 1/2): bitwise
#:             ``baseline_params(chi1)``
#:   dadao   — decoupled gradient/gossip Poisson clocks, as schedule data
ALGORITHM_KINDS = ("a2cid2", "adpsgd", "dadao")
_KIND_ACCELERATED = {"a2cid2": True, "adpsgd": False, "dadao": True}

# rng-stream tag of the decoupled gradient clock: its own SeedSequence child,
# so a coupled algorithm leaves the schedule stream bit for bit untouched
_ALGO_TAG = 0xDADA0


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Declarative algorithm spec: a World axis, lowered at compile time.

    * dynamics column — ``params_for(graph)`` resolves the kind and the
      ``accelerated`` override (None = the kind's canonical form) to the
      ``A2CiD2Params`` that ride the per-world arrays of the batched replay;
    * clock structure — only ``kind="dadao"`` has one: ``grad_rate``
      (Bernoulli thinning of the unit gradient ticks) and ``gossip_rate``
      (replaces ``comms_per_grad`` as the comm-event intensity).  At their
      coupled defaults the schedule is bitwise the coupled one.
    """

    kind: str = "a2cid2"
    accelerated: bool | None = None
    grad_rate: float = 1.0
    gossip_rate: float | None = None

    def __post_init__(self):
        if self.kind not in ALGORITHM_KINDS:
            raise ValueError(f"Algorithm.kind must be one of "
                             f"{ALGORITHM_KINDS}, got {self.kind!r}")
        if self.accelerated is not None and \
                not isinstance(self.accelerated, bool):
            raise ValueError("Algorithm.accelerated must be None or bool, "
                             f"got {self.accelerated!r}")
        gr = self.grad_rate
        if not (isinstance(gr, (int, float)) and 0.0 < float(gr) <= 1.0):
            raise ValueError("Algorithm.grad_rate must be a float in "
                             f"(0, 1], got {gr!r}")
        if self.gossip_rate is not None:
            g = self.gossip_rate
            if not (isinstance(g, (int, float)) and float(g) > 0.0
                    and math.isfinite(float(g))):
                raise ValueError("Algorithm.gossip_rate must be None or a "
                                 f"finite float > 0, got {g!r}")
        if self.kind != "dadao" and (float(gr) != 1.0
                                     or self.gossip_rate is not None):
            raise ValueError(
                f"decoupled clocks (grad_rate/gossip_rate) are a "
                f"kind='dadao' axis; kind={self.kind!r} must keep "
                f"grad_rate=1.0 and gossip_rate=None")

    @property
    def is_accelerated(self) -> bool:
        if self.accelerated is not None:
            return self.accelerated
        return _KIND_ACCELERATED[self.kind]

    def params_for(self, graph) -> A2CiD2Params:
        """The scalar dynamics column for ``graph`` (the adpsgd base arm is
        bitwise ``baseline_params(graph.chi1())``)."""
        return params_from_graph(graph, accelerated=self.is_accelerated)

    @property
    def decoupled(self) -> bool:
        """True iff the spec carries a non-trivial decoupled clock."""
        return self.kind == "dadao" and (
            float(self.grad_rate) != 1.0 or self.gossip_rate is not None)

    def comm_rate(self, comms_per_grad: float) -> float:
        """Comm-event intensity: the independent gossip clock when set, the
        coupled ``comms_per_grad`` otherwise."""
        if self.kind == "dadao" and self.gossip_rate is not None:
            return float(self.gossip_rate)
        return float(comms_per_grad)

    def apply_grad_clock(self, schedule, seed: int):
        """Bernoulli(grad_rate) tick thinning per (round, worker) from the
        algorithm's own rng stream; a unit rate returns ``schedule``."""
        rate = float(self.grad_rate)
        if self.kind != "dadao" or rate == 1.0:
            return schedule
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), _ALGO_TAG]))
        gate = rng.uniform(size=(schedule.rounds, schedule.n)) < rate
        return schedule.with_grad_gate(gate)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "accelerated": self.accelerated,
                "grad_rate": float(self.grad_rate),
                "gossip_rate": None if self.gossip_rate is None
                else float(self.gossip_rate)}

    @staticmethod
    def from_dict(d: dict) -> "Algorithm":
        return Algorithm(kind=d.get("kind", "a2cid2"),
                         accelerated=d.get("accelerated"),
                         grad_rate=d.get("grad_rate", 1.0),
                         gossip_rate=d.get("gossip_rate"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Algorithm":
        return Algorithm.from_dict(json.loads(s))


# ----------------------------------------------------------------- mixing ODE

def mixing_coeff(eta: float, dt: torch.Tensor) -> torch.Tensor:
    """Off-diagonal weight of exp(dt*A): (1 - exp(-2 eta dt)) / 2, in f32
    for an f32 ``dt`` (``-2.0 * eta`` is formed in double, then applied as
    an f32 scalar — how JAX binds the weak Python scalar)."""
    return 0.5 * (1.0 - torch.exp(-2.0 * eta * dt))


def apply_mixing(x: PyTree, x_tilde: PyTree, eta: float, dt
                 ) -> tuple[PyTree, PyTree]:
    """Lazily apply the continuous mixing for an elapsed time ``dt``.

    Exact closed-form flow of the ODE.  ``dt`` is a scalar or a per-worker
    (n,) tensor against leaves shaped (n, ...).  ``eta == 0`` returns the
    inputs untouched: the baseline's exactness rests on it.
    """
    if eta == 0.0:
        return x, x_tilde
    flat_x, treedef = tree_flatten(x)
    flat_t = treedef.flatten_up_to(x_tilde)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=flat_x[0].device)
    c32 = mixing_coeff(eta, dt)

    def mix(a, b):
        c = c32.to(a.dtype)
        c = c.reshape(c.shape + (1,) * (a.dim() - c.dim()))
        d = b - a
        return a + c * d, b - c * d

    mixed = [mix(a, b) for a, b in zip(flat_x, flat_t)]
    return (treedef.unflatten([m[0] for m in mixed]),
            treedef.unflatten([m[1] for m in mixed]))


# -------------------------------------------------------------- event updates

def gradient_event(x: PyTree, x_tilde: PyTree, grads: PyTree, gamma: float
                   ) -> tuple[PyTree, PyTree]:
    """Apply a gradient event: both buffers take the step (Eq 4)."""
    def upd(p, g):
        return p - dtype_scalar(gamma, g.dtype) * g

    return tree_map(upd, x, grads), tree_map(upd, x_tilde, grads)


def p2p_event(x_i: PyTree, x_tilde_i: PyTree, x_j: PyTree,
              params: A2CiD2Params) -> tuple[PyTree, PyTree]:
    """One side of a pairwise averaging event on edge (i, j).

    m = x_i - x_j;  x_i -= alpha*m ; x_tilde_i -= alpha_tilde*m.
    The j side is obtained by calling with roles swapped (m flips sign).
    With alpha = 1/2 the x-update is exact pairwise averaging.
    """
    def upd(a, at, b):
        m = a - b
        return (a - dtype_scalar(params.alpha, a.dtype) * m,
                at - dtype_scalar(params.alpha_tilde, a.dtype) * m)

    flat_i, treedef = tree_flatten(x_i)
    flat_ti = treedef.flatten_up_to(x_tilde_i)
    flat_j = treedef.flatten_up_to(x_j)
    out = [upd(a, at, b) for a, at, b in zip(flat_i, flat_ti, flat_j)]
    return (treedef.unflatten([o[0] for o in out]),
            treedef.unflatten([o[1] for o in out]))


def matched_p2p_update(x: PyTree, x_tilde: PyTree, partner: torch.Tensor,
                       params: A2CiD2Params) -> tuple[PyTree, PyTree]:
    """Apply one matching round to stacked worker states.

    Leaves have a leading worker axis (n, ...).  ``partner[i] = j`` (with
    partner[j] = i) for matched pairs, ``i`` for idle workers — idle workers
    see m = x_i - x_i = 0, a clean no-op.
    """
    partner = partner.long()

    def upd(a, at):
        m = a - a.index_select(0, partner)
        return (a - dtype_scalar(params.alpha, a.dtype) * m,
                at - dtype_scalar(params.alpha_tilde, a.dtype) * m)

    flat_x, treedef = tree_flatten(x)
    flat_t = treedef.flatten_up_to(x_tilde)
    out = [upd(a, at) for a, at in zip(flat_x, flat_t)]
    return (treedef.unflatten([o[0] for o in out]),
            treedef.unflatten([o[1] for o in out]))


# ---------------------------------------------------------------- diagnostics

def consensus_distance(x: PyTree) -> torch.Tensor:
    """||pi x||_F^2 / n = mean squared distance of workers to the mean
    (the quantity tracked in the paper's Fig 5b).  Leaves have a leading
    worker axis."""
    def per_leaf(a):
        mean = a.mean(dim=0, keepdim=True)
        return ((a - mean) ** 2).sum() / a.shape[0]

    return sum(per_leaf(a) for a in tree_leaves(x))


def worker_mean(x: PyTree) -> PyTree:
    return tree_map(lambda a: a.mean(dim=0), x)
