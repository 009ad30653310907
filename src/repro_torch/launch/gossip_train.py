"""Decentralized gossip training steps: the paper's technique across a
worker axis, on one card.

  super-step =  (1) lazy continuous mixing exp(dt*A) of {x, x~}
                (2) one local SGD step on the worker's own batch
                (3) E gossip events: a random matching from the static bank,
                    p2p parameter averaging with the partner

With eta=0, alpha=alpha_t=1/2 this is the asynchronous baseline (Eq 6,
~AD-PSGD); with Prop 3.6 parameters it is A2CiD2.  The AR steps
(all-reduce of the gradients every step) are the AR-SGD baseline.

Two trainers, as in the JAX package:

* ``GossipTrainer`` is the per-worker (SPMD) program.  On a TPU mesh each
  chip runs it on its own replica; here a ``core.gossip.WorkerAxis`` runs
  the W workers in lockstep in one process: one ``loss_fn`` gradient per
  worker, one ``p2p_mixing`` launch per worker and event, and a permute
  that hands each worker its partner's tensor without moving a byte.
* ``StackedGossipTrainer`` has an explicit leading worker axis on every
  state leaf: the gradients are one ``torch.func.vmap`` and a gossip event
  is one ``mixing_gossip_stacked`` launch on the (W, D) buffer.

The random draws of a step (who gossips when, every worker's gradient
clock) come from a torch generator on the host, in one shared draw (the
matchings, gaps, drops and staleness offsets are the same for every
worker; only the gradient clocks are per worker).  Each step takes them
as an optional argument (draw, then apply), so a test can feed the JAX
package's own draws.  The laws are the JAX package's; the bits differ
(torch generators are not JAX keys).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..core.a2cid2 import A2CiD2Params, apply_mixing
from ..core.channel import ChannelModel
from ..core.engine import FlatGossipEngine
from ..core.gossip import (DelayRing, GossipMixer, bank_corruption,
                           bank_edge_rates, check_mesh_channel, drop_draws,
                           matching_bank, matching_draws, stale_draws)
from ..core.graphs import Graph
from ..core.tree import PyTree, tree_flatten, tree_leaves, tree_map
from ..kernels.a2cid2_mixing.ref import dtype_scalar
from ..optim.optimizers import Optimizer, OptState


def _comms_per_step(world) -> int:
    """The world's effective comm intensity as the trainers' whole-event
    count: an ``Algorithm`` with a decoupled gossip clock (DADAO) replaces
    ``comms_per_grad`` here exactly as it does in ``World.compile``.  The
    trainers run a whole number of gossip events per super-step, so a
    fractional declared rate cannot be honored silently."""
    cps = float(world.comms_per_grad)
    if world.algorithm is not None:
        cps = world.algorithm.comm_rate(cps)
    if abs(cps - round(cps)) > 1e-9:
        raise ValueError(
            f"the world's effective comms per step is {cps}, not an "
            "integer; the mesh trainers run a whole number of gossip "
            "events per step — pass comms_per_step explicitly to choose "
            "one")
    return int(round(cps))


def _world_dynamics(world, accelerated: bool | None):
    """Resolve a World's algorithm spec to the trainers' (graph, acid,
    grad_rates) triple.  ``accelerated=None`` takes the algorithm's own arm
    (canonical accelerated A2CiD2 when the world declares no algorithm); a
    bool overrides the arm.  A DADAO decoupled gradient clock folds into
    the per-worker rate vector (the time-dilation realization of the rate
    process the compiled schedule expresses by tick thinning)."""
    from ..core.a2cid2 import Algorithm

    graph = world.static_graph()
    algo = world.algorithm if world.algorithm is not None else Algorithm()
    if accelerated is not None:
        algo = dataclasses.replace(algo, accelerated=bool(accelerated))
    acid = algo.params_for(graph)
    grad_rates = world.workers.grad_rates
    if algo.kind == "dadao" and float(algo.grad_rate) != 1.0:
        base = grad_rates if grad_rates is not None else (1.0,) * graph.n
        grad_rates = tuple(float(r) * float(algo.grad_rate) for r in base)
    return graph, acid, grad_rates


def _rate_vec(grad_rates, n: int) -> torch.Tensor | None:
    """Validated per-worker gradient-rate vector on the host (None =
    homogeneous).  A mis-sized tuple raises: a short vector would divide
    some workers' clocks by a wrong rate."""
    if grad_rates is None:
        return None
    if len(grad_rates) != n:
        raise ValueError(f"grad_rates must have {n} entries, "
                         f"got {len(grad_rates)}")
    return torch.as_tensor(np.asarray(grad_rates, np.float32))


def _check_generator(generator: torch.Generator) -> torch.Generator:
    if generator.device.type != "cpu":
        raise ValueError("the trainers draw on the host: pass a CPU "
                         f"torch.Generator, got one on {generator.device}")
    return generator


def _grad_clocks(generator: torch.Generator, rates, n: int
                 ) -> torch.Tensor:
    """(n,) per-worker gradient gaps ~ Exp(1) / rate_i: stragglers (rate <
    1) see longer gaps."""
    dts = torch.empty(n).exponential_(generator=generator)
    return dts if rates is None else dts / rates


def _device(tree: PyTree) -> torch.device:
    return tree_leaves(tree)[0].device


# --------------------------------------------------------------------------
# SPMD formulation: a per-worker program over the worker axis
# --------------------------------------------------------------------------
class GossipTrainState(NamedTuple):
    """All W workers' states; the per-worker fields are lists indexed by
    worker (worker w's replica is ``params[w]``)."""

    params: list          # x: one replica pytree per worker
    momentum: list        # x~: the A2CiD2 continuous-momentum buffers
    opt: list             # one local optimizer state per worker
    t_last: torch.Tensor  # (W,) worker-local event clocks
    generator: torch.Generator   # host generator of the shared draws
    # one bounded-staleness ring (gossip.DelayRing) per worker when the
    # channel carries a DelayProcess; None otherwise.  A step CONSUMES it:
    # the snapshot push writes a slot of each ring's buffer in place, so
    # the state passed to a step no longer holds the old ring
    ring: Any = None


class GossipDraws(NamedTuple):
    """One SPMD step's random draws, host tensors."""

    dt_grad: torch.Tensor        # (W,) f32 per-worker gradient gaps
    idxs: torch.Tensor           # (E,) int32 shared bank index, -1 dropped
    gaps: torch.Tensor           # (E,) f32 shared event gaps
    stale: torch.Tensor | None   # (E,) int32 shared raw staleness


@dataclasses.dataclass(frozen=True)
class GossipTrainer:
    """The per-worker decentralized step, W workers in lockstep on one
    card.  ``loss_fn(params, batch) -> (loss, metrics)`` for one worker."""

    loss_fn: Callable
    optimizer: Optimizer
    graph: Graph
    acid: A2CiD2Params
    lr: float = 0.1
    comms_per_step: int = 1
    # per-worker gradient rates (straggler clocks): worker i's gradient
    # events arrive at Poisson rate grad_rates[i]; None = all 1
    grad_rates: tuple[float, ...] | None = None
    # unreliable channel: always-on adversary (static per-matching
    # corruption), drops, and delay through each worker's ring;
    # robust_clip/robust_rule engage the robust m-term
    channel: ChannelModel | None = None
    robust_clip: float | None = None
    robust_rule: str = "trim"

    def __post_init__(self):
        check_mesh_channel(self.channel, permute_ring=True)

    @functools.cached_property
    def mixer(self) -> GossipMixer:
        return GossipMixer(self.graph, self.acid, channel=self.channel,
                           robust_clip=self.robust_clip,
                           robust_rule=self.robust_rule)

    @classmethod
    def from_world(cls, world, loss_fn: Callable, optimizer: Optimizer, *,
                   accelerated: bool | None = None, **kw) -> "GossipTrainer":
        """Build the trainer from a declarative ``core.world.World``: a
        static graph (``World.static_graph``) with its link-model rates,
        the worker model's straggler clocks, the effective comm intensity
        as the per-step event count, the dynamics of ``world.algorithm``
        (``accelerated`` overrides the arm) and ``world.channel``."""
        graph, acid, grad_rates = _world_dynamics(world, accelerated)
        if "comms_per_step" not in kw:  # explicit override skips the check
            kw["comms_per_step"] = _comms_per_step(world)
        kw.setdefault("channel", world.channel)
        return cls(loss_fn, optimizer, graph, acid,
                   grad_rates=grad_rates, **kw)

    def init(self, params: PyTree, generator: torch.Generator
             ) -> GossipTrainState:
        """Every worker starts from its own copy of ``params``, on their
        device; ``generator`` (a CPU generator) draws the steps' events."""
        n = self.graph.n
        xs = [tree_map(torch.clone, params) for _ in range(n)]
        delayed = self.channel is not None and self.channel.horizon > 0
        return GossipTrainState(
            params=xs,
            momentum=[tree_map(torch.clone, params) for _ in range(n)],
            opt=[self.optimizer.init(x) for x in xs],
            t_last=torch.zeros(n, device=_device(params)),
            generator=_check_generator(generator),
            ring=self.mixer.init_ring(xs) if delayed else None)

    def sample_draws(self, generator: torch.Generator) -> GossipDraws:
        """One step's draws: the shared events and staleness, and each
        worker's own gradient clock."""
        mixer = self.mixer
        e = self.comms_per_step
        stale = mixer.sample_stale(generator, e) \
            if mixer.delay is not None else None
        idxs, gaps = mixer.sample_event_batch(generator, e)
        dt_grad = _grad_clocks(generator, _rate_vec(self.grad_rates,
                                                    self.graph.n),
                               self.graph.n)
        return GossipDraws(dt_grad, idxs, gaps, stale)

    # ------------------------------------------------------------- the step
    def make_step(self):
        """``step(state, batch, draws=None) -> (state, metrics)``: one
        super-step of every worker.  ``batch`` leaves carry a leading
        worker axis (worker w trains on ``batch[w]``); ``draws`` default to
        ``sample_draws(state.generator)``.  On a delayed channel the step
        consumes ``state.ring`` (its snapshot is written in place; through
        ``shard_mapped_step`` that is the caller's stacked ring): a caller
        that keeps the old state must clone the ring first."""
        mixer = self.mixer
        axis = mixer.axis

        def step(state: GossipTrainState, batch: PyTree,
                 draws: GossipDraws | None = None):
            if draws is None:
                draws = self.sample_draws(state.generator)
            dev = state.t_last.device
            dt_grad = draws.dt_grad.to(dev)
            gaps = draws.gaps.to(dev)
            # (1) + (2): gradient event at each worker's own clock
            xs, xts = mixer.mix(state.params, state.momentum, dt_grad)
            opts, losses, metrics = [], [], []
            for w in axis.index():
                grads, (loss, m) = grad_and_value(
                    self.loss_fn, has_aux=True)(
                        xs[w], tree_map(lambda a: a[w], batch))
                x, opt = self.optimizer.update(grads, state.opt[w], xs[w],
                                               self.lr)
                # the local step moves BOTH buffers (Eq 4); as in the JAX
                # package, by the distance from the pre-mix replica
                xts[w] = tree_map(lambda t, new, old: t + (new - old),
                                  xts[w], x, state.params[w])
                xs[w] = x
                opts.append(opt)
                losses.append(loss)
                metrics.append(m)
            # (3): E gossip events; a delayed channel snapshots each
            # post-gradient replica onto its worker's ring first
            rings = stale = None
            if mixer.delay is not None:
                rings = mixer.push_ring(state.ring, xs)
                stale = draws.stale
            xs, xts = mixer.gossip_events(xs, xts, draws.idxs, gaps,
                                          rings=rings, stale=stale)
            new_state = GossipTrainState(xs, xts, opts,
                                         state.t_last + dt_grad + gaps.sum(),
                                         state.generator, rings)
            return new_state, {"loss": axis.pmean(losses),
                               **_stack_metrics(metrics)}

        return step

    def make_ar_step(self):
        """AR-SGD baseline: a synchronous all-reduce of the gradients over
        the workers every step (x~ = x, no events, the ring dropped)."""
        axis = self.mixer.axis

        def step(state: GossipTrainState, batch: PyTree):
            grads, losses, metrics = [], [], []
            for w in axis.index():
                g, (loss, m) = grad_and_value(self.loss_fn, has_aux=True)(
                    state.params[w], tree_map(lambda a: a[w], batch))
                grads.append(g)
                losses.append(loss)
                metrics.append(m)
            mean = axis.pmean(grads)
            out = [self.optimizer.update(mean, opt, x, self.lr)
                   for x, opt in zip(state.params, state.opt)]
            xs = [o[0] for o in out]
            return (GossipTrainState(xs, list(xs), [o[1] for o in out],
                                     state.t_last + 1.0, state.generator),
                    {"loss": axis.pmean(losses), **_stack_metrics(metrics)})

        return step

    # -------------------------------------------------------------- wiring
    def shard_mapped_step(self, step_fn):
        """The step over the global view, the counterpart of wrapping it in
        ``shard_map`` over the worker axis: the state's per-worker fields
        arrive and leave with a leading worker axis on every leaf (as the
        JAX package's global arrays do, ``stack_workers``), and the step
        runs on per-worker views of them, so a delayed step writes its
        snapshot into the caller's stacked ring."""
        def stepped(state: GossipTrainState, batch: PyTree, *args):
            new, metrics = step_fn(unstack_workers(state), batch, *args)
            return stack_workers(new), metrics

        return stepped


def _stack_metrics(metrics: list[dict]) -> dict:
    """Per-worker metrics, stacked along a leading worker axis."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _stack(trees: list) -> PyTree:
    return tree_map(lambda *ls: torch.stack(ls), trees[0], *trees[1:])


def stack_workers(state: GossipTrainState) -> GossipTrainState:
    """The global view of an SPMD state: every per-worker field as one
    pytree whose leaves carry a leading worker axis (W, ...), the ring as
    ``DelayRing((W, H, D), (W,) rounds)``."""
    opt = OptState(torch.stack([o.step for o in state.opt]),
                   _stack([o.mu for o in state.opt]),
                   None if state.opt[0].nu is None
                   else _stack([o.nu for o in state.opt]))
    ring = None
    if state.ring is not None:
        ring = DelayRing(torch.stack([r.buf for r in state.ring]),
                         torch.tensor([r.round for r in state.ring],
                                      dtype=torch.int32))
    return GossipTrainState(_stack(state.params), _stack(state.momentum),
                            opt, state.t_last, state.generator, ring)


def unstack_workers(state: GossipTrainState) -> GossipTrainState:
    """The inverse of ``stack_workers``: per-worker views (no copies) of a
    global-view state."""
    n = state.t_last.shape[0]

    def row(tree, w):
        return tree_map(lambda a: a[w], tree)

    o = state.opt
    opts = [OptState(o.step[w], row(o.mu, w),
                     None if o.nu is None else row(o.nu, w))
            for w in range(n)]
    rings = None
    if state.ring is not None:
        rounds = [int(r) for r in state.ring.round]
        rings = [DelayRing(state.ring.buf[w], rounds[w]) for w in range(n)]
    return GossipTrainState([row(state.params, w) for w in range(n)],
                            [row(state.momentum, w) for w in range(n)],
                            opts, state.t_last, state.generator, rings)


# --------------------------------------------------------------------------
# Stacked formulation: an explicit leading worker axis
# --------------------------------------------------------------------------
class StackedGossipState(NamedTuple):
    x: PyTree             # leaves (W, ...): worker-stacked replicas
    x_tilde: PyTree
    opt: Any              # stacked optimizer state, (W,) step counters
    generator: torch.Generator
    # (H, W, D) snapshot ring (gossip.DelayRing) on delayed channels: the
    # stacked form holds every worker's history, so reads resolve per
    # READER, the exact DelayProcess law.  A step consumes it (the push
    # writes a slot in place)
    ring: Any = None


class StackedDraws(NamedTuple):
    """One stacked step's random draws, host tensors."""

    dt_grad: torch.Tensor        # (W,) f32 per-worker gradient gaps
    idxs: torch.Tensor           # (E,) int32 bank index, -1 dropped
    gaps: torch.Tensor           # (E, W) f32 per-worker event gaps
    stales: torch.Tensor | None  # (E, W) int32 per-reader raw staleness


class PairRingDraws(NamedTuple):
    """One pair-ring step's random draws, host tensors."""

    dt_grad: torch.Tensor   # (W,) f32
    odds: torch.Tensor      # (E,) bool: the odd matching
    gaps: torch.Tensor      # (E, W) f32


@dataclasses.dataclass(frozen=True)
class StackedGossipTrainer:
    """Decentralized A2CiD2 trainer with an explicit leading worker axis.

    Every state leaf carries a leading (n_workers,) dim; the per-worker
    gradient step is a ``torch.func.vmap`` and a gossip event is one fused
    launch on the (W, D) buffer (the same code path as the simulator's
    engine).  ``grad_fn(params_i, batch_i) -> ((loss, aux), grads)`` for ONE
    worker; vmapped.
    """

    grad_fn: Callable
    optimizer: Optimizer
    graph: Graph
    acid: A2CiD2Params
    lr: float = 0.1
    comms_per_step: int = 1
    # per-worker gradient rates (straggler clocks), see GossipTrainer
    grad_rates: tuple[float, ...] | None = None
    # unreliable channel, see GossipTrainer; delay via the stacked
    # (H, W, D) snapshot ring
    channel: ChannelModel | None = None
    robust_clip: float | None = None
    robust_rule: str = "trim"

    def __post_init__(self):
        check_mesh_channel(self.channel, permute_ring=True)

    @classmethod
    def from_world(cls, world, grad_fn: Callable, optimizer: Optimizer, *,
                   accelerated: bool | None = None,
                   **kw) -> "StackedGossipTrainer":
        """Build the trainer from a declarative ``core.world.World``; see
        ``GossipTrainer.from_world``."""
        graph, acid, grad_rates = _world_dynamics(world, accelerated)
        if "comms_per_step" not in kw:  # explicit override skips the check
            kw["comms_per_step"] = _comms_per_step(world)
        kw.setdefault("channel", world.channel)
        return cls(grad_fn, optimizer, graph, acid,
                   grad_rates=grad_rates, **kw)

    @functools.cached_property
    def bank(self) -> np.ndarray:
        return matching_bank(self.graph)

    @property
    def _delay(self):
        d = None if self.channel is None else self.channel.delay
        return None if d is None or d.is_trivial else d

    @property
    def _drop_prob(self) -> float:
        return 0.0 if self.channel is None else self.channel.drop_prob

    def init(self, params0: PyTree, generator: torch.Generator
             ) -> StackedGossipState:
        n = self.graph.n
        stack = tree_map(lambda a: a.unsqueeze(0).repeat(
            (n,) + (1,) * a.dim()), params0)
        ring = None
        if self.channel is not None and self.channel.horizon > 0:
            bx = FlatGossipEngine.for_pytree(stack, self.acid).pack(stack)
            ring = DelayRing(bx.unsqueeze(0).repeat(
                self.channel.horizon, 1, 1), -1)
        opt = self.optimizer.init(stack)
        # one step counter per worker, as jax.vmap(optimizer.init) gives
        opt = opt._replace(step=opt.step.repeat(n))
        return StackedGossipState(x=stack, x_tilde=tree_map(torch.clone,
                                                            stack),
                                  opt=opt,
                                  generator=_check_generator(generator),
                                  ring=ring)

    def _vmapped_grads(self, x: PyTree, batch: PyTree):
        """(losses (W,), grads) of every worker, one ``vmap`` of
        ``grad_fn``; its aux output is dropped (as the JAX package drops
        it), so it may be None."""
        def loss_and_grads(p, b):
            (loss, _aux), grads = self.grad_fn(p, b)
            return loss, grads

        return vmap(loss_and_grads)(x, batch)

    def _local_step(self, state: StackedGossipState, batch: PyTree,
                    dt_grad: torch.Tensor):
        """Mix each worker for its gradient gap, then one vmapped gradient
        and local optimizer step that moves both buffers (Eq 4)."""
        x, xt = apply_mixing(state.x, state.x_tilde, self.acid.eta,
                             dt_grad.to(_device(state.x)))
        losses, grads = self._vmapped_grads(x, batch)
        x2, opt = self.optimizer.update(grads, state.opt, x, self.lr)
        xt = tree_map(lambda t, a, b: t + (a - b), xt, x2, x)
        return x2, xt, opt, losses

    def sample_draws(self, generator: torch.Generator) -> StackedDraws:
        n, e = self.graph.n, self.comms_per_step
        stales = None if self._delay is None \
            else stale_draws(self._delay, generator, (e, n))
        dt_grad = _grad_clocks(generator, _rate_vec(self.grad_rates, n), n)
        idxs = drop_draws(matching_draws(bank_edge_rates(
            self.graph, self.bank), generator, e), generator,
            self._drop_prob)
        gaps = torch.empty((e, n)).exponential_(generator=generator) \
            / max(e, 1)
        return StackedDraws(dt_grad, idxs, gaps, stales)

    def make_step(self):
        """``step(state, batch, draws=None) -> (state, metrics)``: mixing,
        the vmapped local step, then E events on the flat (W, D) buffers,
        one fused launch each (the channel kernel with pre-gathered partner
        values when the channel or a robust rule is on; a dropped event
        keeps only its mixing segment).  On a delayed channel the step
        consumes ``state.ring``: the snapshot is written in place."""
        bank_np = self.bank
        n = self.graph.n
        acid = self.acid
        corrupt_np = bank_corruption(
            bank_np, None if self.channel is None else self.channel.adversary)
        delay = self._delay
        channel_on = (self.robust_clip is not None or bool(corrupt_np.any())
                      or self._drop_prob > 0.0 or delay is not None)
        involved = bank_np != np.arange(n)

        def step(state: StackedGossipState, batch: PyTree,
                 draws: StackedDraws | None = None):
            if draws is None:
                draws = self.sample_draws(state.generator)
            x, xt, opt, losses = self._local_step(state, batch,
                                                  draws.dt_grad)
            dev = _device(x)
            engine = FlatGossipEngine.for_pytree(
                x, acid, stacked=True, robust_clip=self.robust_clip,
                robust_rule=self.robust_rule)
            ring = state.ring
            if delay is not None:
                # snapshot the post-gradient stack at the grad tick
                r = ring.round + 1
                ring.buf[r % delay.horizon].copy_(engine.pack(x))
                ring = DelayRing(ring.buf, r)
            idxs = [int(i) for i in draws.idxs]
            if not idxs:
                return (StackedGossipState(x, xt, opt, state.generator,
                                           ring),
                        {"loss": losses.mean()})
            gaps = draws.gaps.to(dev)
            bx, bxt = engine.pack(x), engine.pack(xt)
            bx, bxt = engine.mix(bx, bxt, gaps[0])
            gaps_next = torch.cat([gaps[1:], gaps.new_zeros((1, n))])
            bank = torch.as_tensor(bank_np, device=dev)
            if channel_on:
                corrupt = torch.as_tensor(corrupt_np, device=dev)
            if delay is not None:
                # per-reader source slots, resolved on the host: the ring
                # slot of a stale read, the sentinel H for a fresh one (an
                # idle worker stays fresh, so its event is an exact no-op)
                h, r = delay.horizon, ring.round
                src = np.full((len(idxs), n), h, np.int64)
                for e, idx in enumerate(idxs):
                    s = np.where(involved[max(idx, 0)],
                                 np.minimum(np.asarray(draws.stales[e]),
                                            max(r, 0)), 0)
                    src[e] = np.where(s > 0, (r - s) % h, h)
                src = torch.as_tensor(src, device=dev)
            for e, idx in enumerate(idxs):
                dtn = gaps_next[e]
                if idx < 0:
                    bx, bxt = engine.mix(bx, bxt, dtn)
                elif channel_on:
                    xp = engine.partner_values(ring.buf, bx, bank[idx],
                                               src[e]) \
                        if delay is not None \
                        else bx.index_select(0, bank[idx].long())
                    bx, bxt = engine.channel_batch(bx, bxt, xp, corrupt[idx],
                                                   dtn)
                else:
                    bx, bxt = engine.batch(bx, bxt, bank[idx], dtn)
            return (StackedGossipState(engine.unpack(bx), engine.unpack(bxt),
                                       opt, state.generator, ring),
                    {"loss": losses.mean()})

        return step

    def sample_pair_ring_draws(self, generator: torch.Generator
                               ) -> PairRingDraws:
        n, e = self.graph.n, self.comms_per_step
        dt_grad = _grad_clocks(generator, _rate_vec(self.grad_rates, n), n)
        odds = torch.rand(e, generator=generator) < 0.5
        gaps = torch.empty((e, n)).exponential_(generator=generator) \
            / max(e, 1)
        return PairRingDraws(dt_grad, odds, gaps)

    def make_pair_ring_step(self):
        """Ring-graph gossip with pair-local exchanges.

        A ring's two maximal matchings pair adjacent workers: the even
        matching's pairwise average is a mean over (W/2, 2) pairs, the odd
        matching the same after a roll(1) of the worker axis.  The A2CiD2
        x~ update needs only m = 2*(x - pairmean).  No gossip kernel runs:
        each event is plain elementwise PyTorch on the stacked leaves.
        """
        if self.graph.name != "ring" or self.graph.n % 2:
            raise ValueError("make_pair_ring_step needs a ring of an even "
                             f"number of workers, got {self.graph.name!r} "
                             f"with n={self.graph.n}")
        n = self.graph.n
        acid = self.acid

        def pair_mean(t):  # (W, ...) -> mean over adjacent even pairs
            r = t.reshape((n // 2, 2) + t.shape[1:])
            return r.mean(dim=1, keepdim=True).expand(r.shape).reshape(
                t.shape)

        def p2p(x, xt, odd):
            def upd(a, at):
                a2 = torch.roll(a, -1, dims=0) if odd else a
                mdiff = dtype_scalar(2.0, a.dtype) * (a2 - pair_mean(a2))
                new_a = a2 - dtype_scalar(acid.alpha, a.dtype) * mdiff
                if odd:
                    new_a = torch.roll(new_a, 1, dims=0)
                    mdiff = torch.roll(mdiff, 1, dims=0)
                return new_a, at - dtype_scalar(acid.alpha_tilde,
                                                a.dtype) * mdiff

            flat_x, treedef = tree_flatten(x)
            out = [upd(a, at) for a, at in zip(flat_x,
                                               treedef.flatten_up_to(xt))]
            return (treedef.unflatten([o[0] for o in out]),
                    treedef.unflatten([o[1] for o in out]))

        def step(state: StackedGossipState, batch: PyTree,
                 draws: PairRingDraws | None = None):
            if draws is None:
                draws = self.sample_pair_ring_draws(state.generator)
            x, xt, opt, losses = self._local_step(state, batch,
                                                  draws.dt_grad)
            gaps = draws.gaps.to(_device(x))
            for odd, gap in zip(draws.odds.tolist(), gaps):
                x, xt = apply_mixing(x, xt, acid.eta, gap)
                x, xt = p2p(x, xt, odd)
            return (StackedGossipState(x, xt, opt, state.generator),
                    {"loss": losses.mean()})

        return step

    def make_ar_step(self):
        """AR-SGD baseline on the same stack: every step averages the
        gradients over the worker axis (the paper's synchronous
        reference)."""

        def step(state: StackedGossipState, batch: PyTree):
            losses, grads = self._vmapped_grads(state.x, batch)
            grads = tree_map(lambda g: g.mean(dim=0, keepdim=True)
                             .expand(g.shape), grads)
            x, opt = self.optimizer.update(grads, state.opt, state.x,
                                           self.lr)
            return (StackedGossipState(x, tree_map(torch.clone, x), opt,
                                       state.generator),
                    {"loss": losses.mean()})

        return step
