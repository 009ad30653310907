"""Discrete-event simulator of Algorithm 1.

Simulates n asynchronous workers on one device: every leaf of the worker
state carries a leading worker axis ``(n, ...)``, gradients are computed for
all workers in one batched call, and the Poisson event schedule
(``events.Schedule``) is replayed exactly:

  for each comm event e (time u_e, matching P_e):
      involved workers apply the lazy mixing exp((u_e - t_last) A)   [Algo 1 l.17]
      then the p2p update  x -= alpha*m, x~ -= alpha_t*m             [l.18-19]
  at each worker's gradient time t_g:
      lazy mixing exp((t_g - t_last) A)                              [l.9]
      gradient step on BOTH buffers                                  [Eq 4]

Two replay paths, as in the JAX package:

  * ``run`` — the per-event reference: one unfused (mix, p2p) pytree sweep
    per schedule slot, masked slots included.  It is the equivalence oracle.
  * ``run_coalesced`` — the flat-buffer event engine (the default of
    ``run_schedule``): the schedule is compiled host-side to an event stream
    of fused comm batches and gradient ticks, and each comm batch is ONE
    launch of the Hopper kernel on the packed (n, D) buffers.  On the card
    the rest of each gradient tick (the step, the metrics row, the
    trailing mixing segment) is one more hand kernel's pass
    (``FlatGossipEngine.tick``), which reads the gradient leaves in place.

Both paths have unreliable-channel twins (``run_channel`` and
``run_channel_coalesced``) that ``run_schedule`` takes when the schedule
carries ``stale``/``corrupt`` extras or robust aggregation is on: they keep
a ring of the last H states (one snapshot per round, taken right after the
gradient tick) to serve stale partner reads, apply per-event corruption
multipliers, and trim/clip the p2p delta (``robust_clip``/``robust_rule``).
Each engine comm batch is then ONE launch of the channel kernel.  Given
``defense=AdaptiveDefense(...)`` the same twins run the self-healing
control loop (``core/defense.py``): per comm step the delta norms feed
``defense_comm``, the kernel's rejection mask feeds ``defense_absorb``, and
each gradient tick runs ``defense_grad``.  Channel-free schedules run the
plain paths.

The JAX ``lax.scan``/``lax.cond`` become a host loop over the precomputed
stream.  ``is_grad`` and the ring slots stay on the host, the per-step
schedule arrays are copied to the device once, and the per-round metrics
and the defense state stay on the device until the replay ends, so the
loop never waits for the card.  A ``Telemetry`` spec (``core/telemetry.py``)
threads a small f32 accumulator of applied and rejected reads and delta-norm
moments through the channel flavours' comm steps, emitted and reset at each
gradient tick; it forces the channel flavour even for a clean schedule (at
horizon 0, corrupt 0 and mscale 1 the channel kernel is the clean one), and
with ``telemetry=None`` nothing of it runs.  ``mesh=`` runs the sharded
replay (``launch/mesh_replay.py``): the worlds' worker axis split over the
shards of a replay mesh, bit for bit the single-device replay at lag 0.

``run_worlds`` replays B independent worlds at once, in the engine's three
flavors (plain, channel, defense) on (B, W, D) buffers and (B, H, W, D)
snapshot rings: the B worlds' streams are aligned so their gradient ticks
share steps (``events.stack_streams``), each comm step is ONE launch of a
world-batched kernel with the per-world dynamics as (B,) device tensors,
and each gradient tick calls ``grad_fn`` once per world with that world's
generator, so row b draws what world b's serial replay draws.  With
``engine=False`` it runs each world's serial per-event replay on the
padded batched schedule arrays (the oracle).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..analysis import tracing
from ..device import resolve_device
from ..kernels.a2cid2_mixing.ref import dtype_scalar
from .a2cid2 import (A2CiD2Params, apply_mixing, consensus_distance,
                     matched_p2p_update, worker_mean)
from .channel import CORRUPT_KEY, STALE_KEY
from .defense import (DefenseTrace, defense_absorb, defense_comm,
                      defense_grad, defense_init, knobs_single, knobs_worlds)
from .engine import FlatGossipEngine, _delta_f32, norm_scale
from .events import (Schedule, coalesce_schedule, coalesced_stream,
                     shard_lag_stale, shard_partition, stack_schedules,
                     stack_streams)
from .flatbuf import (FlatLayout, ring_init, ring_init_worlds, ring_push,
                      ring_push_worlds, ring_read)
from .telemetry import (Telemetry, batch_schedule_columns, finalize_trace,
                        row_bytes_of, schedule_columns)
from .tree import PyTree, tree_flatten, tree_leaves, tree_map

# grad_fn(x_stacked, generator, worker_ids) -> (losses (n,), grads) for ALL
# workers at once: ``x_stacked`` is the state pytree with leaves (n, ...),
# ``worker_ids`` the (n,) int64 ids on the state's device, ``grads`` a pytree
# like ``x_stacked``.  Randomness (each worker's data draw) comes from
# ``generator``.  The JAX package vmaps a per-worker function over split
# keys instead; torch generators do not split, so the port batches here.
GradFn = Callable[[PyTree, torch.Generator, torch.Tensor],
                  tuple[torch.Tensor, PyTree]]


@dataclasses.dataclass(frozen=True)
class SplitGradFn:
    """A ``GradFn`` in two halves, the draw and its use.

    ``draw(generator, n)`` draws the batch of all n workers of a world: a
    pytree of tensors with a leading worker axis.  ``apply(x_rows,
    batch_rows, worker_ids)`` returns the losses and gradients of the
    given rows (``worker_ids`` names them).  Called as a ``GradFn`` it is
    ``apply(x, draw(generator, n), ids)``, so a replay on one device sees
    no difference.  The sharded replay (``mesh=``) draws the whole world's
    batch and applies only a shard's rows: a shard's draws are then the
    single-device stream's, and the generator ends where the single-device
    replay leaves it.  A plain callable cannot be split, and the sharded
    replay refuses it on more than one shard.
    """

    draw: Callable[[torch.Generator, int], PyTree]
    apply: Callable[[PyTree, PyTree, torch.Tensor],
                    tuple[torch.Tensor, PyTree]]

    def __call__(self, x_stacked: PyTree, generator: torch.Generator,
                 worker_ids: torch.Tensor) -> tuple[torch.Tensor, PyTree]:
        return self.apply(x_stacked,
                          self.draw(generator, worker_ids.shape[0]),
                          worker_ids)


class SimState(NamedTuple):
    """One world's state, or B worlds' (``Simulator.batch_states``): leaves
    (B, n, ...), t_last (B, n) and a tuple of B generators, one per world
    (torch generators do not split as JAX keys do)."""
    x: PyTree                    # leaves (n, ...)
    x_tilde: PyTree              # leaves (n, ...)
    t_last: torch.Tensor         # (n,) f32 last per-worker event time
    generator: Any               # torch.Generator of the gradient ticks


class SimTrace(NamedTuple):
    loss: torch.Tensor             # (rounds,) mean worker loss
    consensus: torch.Tensor        # (rounds,) ||pi x||^2 / n
    mean_param_norm: torch.Tensor  # (rounds,)
    # control-loop trace (defense.DefenseTrace) on the self-healing
    # replays, None elsewhere
    defense: Any = None
    # flight-recorder columns (telemetry.TelemetryTrace) when a Telemetry
    # spec was passed, None elsewhere; inside the replay loops it briefly
    # holds the raw runtime tuple, which the entry points finalize
    telemetry: Any = None


def _stack_rows(rows, cls, dim: int = 0):
    """Per-round tuples of 0-d tensors -> ``cls`` of (rounds,) tensors; of
    (B,) tensors with ``dim=1`` -> (B, rounds)."""
    return cls(*(torch.stack(c, dim=dim) for c in zip(*rows)))


def _count_call(engine: FlatGossipEngine, n: int, is_grad, grad_pos,
                pairs, fused: bool = False) -> None:
    """The replay call's counters, from host data only: rounds, gradient
    ticks, comm steps, the directed pairs they exchange, and the bytes the
    comm steps move at least (x and x~ of each of the n workers read and
    written once a step: 4 n D element sizes).  A call whose ticks take
    the one-pass tail (``fused``: the clean replay on the card) also
    counts them as ``fused_ticks``."""
    comm = ~np.asarray(is_grad, dtype=bool)
    steps = int(comm.sum())
    row_bytes = engine.layout.d * engine.layout.buf_dtype.itemsize
    fused_ticks = {"fused_ticks": len(comm) - steps} if fused else {}
    tracing.count("replay", rounds=len(grad_pos), ticks=len(comm) - steps,
                  steps=steps, pairs=int(pairs[comm].sum()),
                  comm_bytes=steps * 4 * n * row_bytes, **fused_ticks)


def _check_telemetry(telemetry) -> None:
    if telemetry is not None and not isinstance(telemetry, Telemetry):
        raise ValueError("telemetry must be a telemetry.Telemetry, "
                         f"got {type(telemetry).__name__}")


# the runtime telemetry columns of ``_round_channel``'s metrics, in the
# accumulator's order
_TEL_COLUMNS = ("tel_applied", "tel_rejected", "tel_norm_sum", "tel_norm_sq")


def _tel_zeros(shape, device):
    """A fresh telemetry accumulator: (applied, rejected, norm_sum,
    norm_sq_sum), f32 scalars serially or (B,) world-batched."""
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z, z, z, z)


def _tel_step(acc, involved, rej, nrm, batched: bool = False):
    """Fold one comm step into the accumulator.  ``involved`` is the
    directed-read mask ((n,) or (B, n)), ``rej`` the rejected subset,
    ``nrm`` the per-read channel-delta norms; the moments are taken over
    ADMITTED reads only (rejected garbage would swamp them)."""
    a_cnt, r_cnt, s1, s2 = acc
    inv = involved.float()
    rj = rej.float() * inv
    adm = inv - rj
    dim = 1 if batched else 0
    nf = nrm.float()
    return (a_cnt + adm.sum(dim), r_cnt + rj.sum(dim),
            s1 + (nf * adm).sum(dim), s2 + (nf * nf * adm).sum(dim))


def _finish(trace: SimTrace, trows, dim: int = 0) -> SimTrace:
    """Attach the emitted accumulator rows as the raw runtime columns."""
    if trows is None:
        return trace
    return trace._replace(telemetry=tuple(torch.stack(c, dim=dim)
                                          for c in zip(*trows)))


def _cadv(corrupt: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(1 + corrupt) in f32, rounded to ``a``'s dtype, shaped to broadcast
    against the (n, ...) leaf ``a``."""
    c = (1.0 + corrupt.float()).to(a.dtype)
    return c.reshape(c.shape + (1,) * (a.dim() - 1))


def _per_worker(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(n,) per-worker scale at ``a``'s dtype, broadcastable against it."""
    v = v.to(a.dtype)
    return v.reshape(v.shape + (1,) * (a.dim() - 1))


@dataclasses.dataclass(frozen=True)
class Simulator:
    grad_fn: GradFn
    params: A2CiD2Params
    gamma: float
    # robust aggregation against Byzantine channels: None = plain m-term;
    # with tau = robust_clip, robust_rule is 'trim' (reject the delta when
    # ||m|| > tau), 'clip' (rescale to norm tau) or 'coord' (clip each
    # coordinate)
    robust_clip: float | None = None
    robust_rule: str = "trim"
    device: Any = "cuda"   # the card unless the caller names the CPU

    def __post_init__(self):
        if self.robust_rule not in ("trim", "clip", "coord"):
            raise ValueError("robust_rule must be 'trim', 'clip', or "
                             f"'coord', got {self.robust_rule!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def init(self, x0: PyTree, n: int, generator: torch.Generator
             ) -> SimState:
        """All workers start at consensus (paper: one all-reduce before
        training).  The two buffers are separate copies: the engine's
        kernel updates x~ in place."""
        def stack(a):
            a = torch.as_tensor(a, device=self.device)
            return a.unsqueeze(0).expand((n,) + a.shape).contiguous()

        return SimState(x=tree_map(stack, x0), x_tilde=tree_map(stack, x0),
                        t_last=torch.zeros(n, dtype=torch.float32,
                                           device=self.device),
                        generator=generator)

    # ------------------------------------------------ telemetry accounting
    def _tel_rej(self, nrm: torch.Tensor, tau=None) -> torch.Tensor:
        """Rejected-read mask under the replay's robust rule.  Only the trim
        rule REJECTS a read; 'clip' and 'coord' attenuate but still apply
        it.  ``tau`` ((B,) f32 per-world thresholds) overrides the static
        threshold; tau = inf rejects nothing."""
        tval = tau if tau is not None else self.robust_clip
        if tval is None or self.robust_rule != "trim":
            return torch.zeros_like(nrm)
        t = torch.as_tensor(tval, dtype=torch.float32, device=nrm.device)
        t = t.reshape(t.shape + (1,) * (nrm.dim() - t.dim()))
        return (nrm > t).float()

    @staticmethod
    def _row_bytes(state: SimState, worlds: bool = False) -> int:
        """Flat-row transfer size for the bytes-moved column; the sum of
        the leaf widths where no flat buffer can hold the tree."""
        try:
            return row_bytes_of(FlatLayout.from_pytree(
                state.x, stacked=True, worlds=worlds))
        except TypeError:
            lead = 2 if worlds else 1
            return sum(int(np.prod(leaf.shape[lead:], dtype=np.int64))
                       * leaf.element_size()
                       for leaf in tree_leaves(state.x))

    # ------------------------------------------------------ per-event path
    def reference_arrays(self, sched: Schedule):
        """Schedule arrays for the per-event reference replay (``run``)."""
        dev = self.device
        return (torch.as_tensor(sched.partners, device=dev).long(),
                torch.as_tensor(sched.event_times, device=dev),
                torch.as_tensor(sched.event_mask, device=dev),
                torch.as_tensor(sched.grad_times, device=dev),
                torch.as_tensor(sched.grad_scale(), device=dev),
                torch.as_tensor(sched.alive_arr(), device=dev))

    def _comm_mix(self, x, xt, t_last, partner, time, mask, ids):
        """Lazy mixing of the involved workers up to the event time (their
        clocks advance); returns (x, x~, t_last, involved)."""
        involved = (partner != ids) & mask
        dt = torch.where(involved, time - t_last, 0.0)
        x, xt = apply_mixing(x, xt, self.params.eta, dt)
        return x, xt, torch.where(involved, time, t_last), involved

    def _gradient_round(self, x, xt, t_last, generator, grad_times,
                        grad_scale, alive, ids):
        """The per-event path's gradient tick: mixing up to each worker's
        gradient time, the batched gradient step on both buffers, the
        round's metrics row.  Detached workers neither advance their clock
        nor mix; stragglers advance and mix but skip the gradient."""
        dt = torch.where(alive, grad_times - t_last, 0.0)
        x, xt = apply_mixing(x, xt, self.params.eta, dt)
        losses, grads = self.grad_fn(x, generator, ids)

        def upd(p, g):
            sc = grad_scale.reshape(grad_scale.shape
                                    + (1,) * (g.dim() - 1)).to(g.dtype)
            return p - dtype_scalar(self.gamma, g.dtype) * (sc * g)

        x, xt = tree_map(upd, x, grads), tree_map(upd, xt, grads)
        row = (losses.mean().float(), consensus_distance(x).float(),
               sum((m ** 2).sum() for m in
                   tree_leaves(worker_mean(x))).float())
        return x, xt, torch.where(alive, grad_times, t_last), row

    def run(self, state: SimState, schedule_arrays
            ) -> tuple[SimState, SimTrace]:
        """Per-event reference replay (unfused, sweeps masked slots too)."""
        partners, times, mask, grad_times, grad_scale, alive = schedule_arrays
        x, xt, t_last = state.x, state.x_tilde, state.t_last
        ids = torch.arange(t_last.shape[0], device=t_last.device)
        rows = []
        for r in range(partners.shape[0]):
            for k in range(partners.shape[1]):
                x, xt, t_last, _ = self._comm_mix(
                    x, xt, t_last, partners[r, k], times[r, k], mask[r, k],
                    ids)
                x, xt = matched_p2p_update(x, xt, partners[r, k],
                                           self.params)
            x, xt, t_last, row = self._gradient_round(
                x, xt, t_last, state.generator, grad_times[r],
                grad_scale[r], alive[r], ids)
            rows.append(row)
        return (SimState(x, xt, t_last, state.generator),
                _stack_rows(rows, SimTrace))

    # ------------------------------------------- per-event channel path
    @staticmethod
    def _delta_norms_tree(x, xp, corrupt):
        """Pytree twin of ``FlatGossipEngine.delta_norms``: (n,) f32 L2
        norms of the corrupted channel deltas (per-leaf f32 square-sums)."""
        flat_x, treedef = tree_flatten(x)
        flat_p = treedef.flatten_up_to(xp)
        nrm2 = sum((_delta_f32(a, _cadv(corrupt, a) * b) ** 2)
                   .reshape(a.shape[0], -1).sum(dim=1)
                   for a, b in zip(flat_x, flat_p))
        return torch.sqrt(nrm2)

    def _p2p_from(self, x, xt, xp, corrupt, mscale=None, clip=None):
        """p2p update from received values: m = x - (1+corrupt) xp, scaled
        by a per-worker ``mscale`` or clipped per coordinate to ``clip``."""
        p = self.params

        def upd(a, at, b):
            m = a - _cadv(corrupt, a) * b
            if mscale is not None:
                m = m * _per_worker(mscale, a)
            elif clip is not None:
                c = dtype_scalar(clip, a.dtype)
                m = torch.clamp(m, -c, c)
            return (a - dtype_scalar(p.alpha, a.dtype) * m,
                    at - dtype_scalar(p.alpha_tilde, a.dtype) * m)

        flat_x, treedef = tree_flatten(x)
        out = [upd(a, at, b) for a, at, b in
               zip(flat_x, treedef.flatten_up_to(xt),
                   treedef.flatten_up_to(xp))]
        return (treedef.unflatten([o[0] for o in out]),
                treedef.unflatten([o[1] for o in out]))

    def _channel_p2p(self, x, xt, xp, corrupt):
        """p2p update with the robust rule on the m-term: a norm trim/clip
        across the whole replica (the engine's flat-row norm), or the
        per-coordinate clip."""
        tau, rule = self.robust_clip, self.robust_rule
        if tau is None or rule == "coord":
            return self._p2p_from(x, xt, xp, corrupt, clip=tau)
        mscale = norm_scale(self._delta_norms_tree(x, xp, corrupt), tau,
                            rule)
        return self._p2p_from(x, xt, xp, corrupt, mscale=mscale)

    @staticmethod
    def _channel_extras(extras: dict, shape):
        """(stale, corrupt, horizon) materialized at ``shape`` (zeros where
        a key is absent); the ring depth is the largest staleness the
        schedule demands, so replays are self-contained."""
        stale = extras.get(STALE_KEY)
        stale = np.zeros(shape, np.int32) if stale is None \
            else np.asarray(stale, np.int32)
        corrupt = extras.get(CORRUPT_KEY)
        corrupt = np.zeros(shape, np.float32) if corrupt is None \
            else np.asarray(corrupt, np.float32)
        horizon = int(stale.max()) if stale.size else 0
        return stale, corrupt, horizon

    def channel_reference_arrays(self, sched: Schedule):
        """Per-event channel replay inputs + the ring depth H.  A read in
        round r that is s rounds stale is served from ring slot
        ``(r - s) mod H``; the sentinel H means a fresh read.  ``ring_pos``
        (the slot each round's snapshot goes to) stays host numpy."""
        R, K, n = sched.partners.shape
        stale, corrupt, horizon = self._channel_extras(sched.extras_dict(),
                                                       (R, K, n))
        h = max(horizon, 1)
        rr = np.arange(R)[:, None, None]
        src_slot = np.where(stale > 0, (rr - stale) % h,
                            horizon).astype(np.int32)
        ring_pos = (np.arange(R) % h).astype(np.int32)
        partners, times, mask, grad_times, grad_scale, alive = \
            self.reference_arrays(sched)
        dev = self.device
        return (partners, times, mask,
                torch.as_tensor(src_slot, device=dev).long(),
                torch.as_tensor(corrupt, device=dev), grad_times,
                grad_scale, alive, ring_pos), horizon

    def _round_channel(self, horizon: int, carry, round_sched, tel=None,
                       knobs=None):
        """One round of the per-event channel replay: the round's comm
        events (stale reads from the ring of per-round snapshots, corrupted
        received values, the robust m-term), then the gradient tick and
        the end-of-round snapshot.

        ``carry`` is ``(x, x~, t_last, ring, generator)`` (``ring`` None at
        horizon 0), followed by the defense state when defense ``knobs``
        (``defense.knobs_single``) run the self-healing loop per event;
        ``round_sched`` is one round of ``channel_reference_arrays``.
        Returns ``(carry, metrics)``: ``loss``, ``consensus`` and
        ``mean_param_norm``, the ``tel_*`` accumulator columns with a
        telemetry spec ``tel``, and the ``DefenseTrace`` fields with
        knobs.  The ring is written in place; nothing else is."""
        x, xt, t_last, ring, generator = carry[:5]
        ds = carry[5] if knobs is not None else None
        (partners, times, mask, src_slots, corrupts, grad_times, grad_scale,
         alive, ring_pos) = round_sched
        ids = torch.arange(t_last.shape[0], device=t_last.device)
        acc = None if tel is None else _tel_zeros((), t_last.device)
        for k in range(partners.shape[0]):
            partner, corrupt = partners[k], corrupts[k]
            x, xt, t_last, involved = self._comm_mix(
                x, xt, t_last, partner, times[k], mask[k], ids)
            if horizon:
                xp = tree_map(lambda a, ra: ring_read(
                    ra, a, partner, src_slots[k]), x, ring)
            else:
                xp = tree_map(lambda a: a.index_select(0, partner), x)
            if ds is None:
                if acc is not None:
                    nrm = self._delta_norms_tree(x, xp, corrupt)
                    acc = _tel_step(acc, involved, self._tel_rej(nrm), nrm)
                # idle/masked rows read themselves fresh with corrupt 0, so
                # m = 0
                x, xt = self._channel_p2p(x, xt, xp, corrupt)
                continue
            nrm = self._delta_norms_tree(x, xp, corrupt)
            mscale, quar, ds = defense_comm(knobs, ds, partner, involved,
                                            nrm)
            x, xt = self._p2p_from(x, xt, xp, corrupt, mscale=mscale)
            # the kernel's rejection output IS (mscale == 0)
            rej = (mscale == 0.0).float()
            ds = defense_absorb(ds, rej, quar, involved)
            if acc is not None:
                acc = _tel_step(acc, involved, rej, nrm)
        x, xt, t_last, row = self._gradient_round(
            x, xt, t_last, generator, grad_times, grad_scale, alive, ids)
        metrics = dict(zip(SimTrace._fields[:3], row))
        if acc is not None:
            metrics.update(zip(_TEL_COLUMNS, acc))
        if ds is not None:
            ds, drow = defense_grad(knobs, ds)
            metrics.update(zip(DefenseTrace._fields, drow))
        if horizon:
            # end-of-round snapshot: post-gradient, pre-trailing-mixing
            tree_map(lambda ra, a: ring_push(ra, a, int(ring_pos)), ring, x)
        carry = (x, xt, t_last, ring, generator)
        return (carry if ds is None else carry + (ds,)), metrics

    def run_channel(self, state: SimState, schedule_arrays, horizon: int,
                    knobs=None, tel: Telemetry | None = None
                    ) -> tuple[SimState, SimTrace]:
        """Per-event channel replay: ``_round_channel`` over the rounds of
        ``channel_reference_arrays``.  With defense ``knobs``
        (``defense.knobs_single``) the self-healing loop runs per event and
        the trace carries a ``DefenseTrace``; with a telemetry spec ``tel``
        each round's accumulator rides along and the trace carries its raw
        runtime columns."""
        t_last = state.t_last
        ring = tree_map(lambda a: ring_init(a, horizon), state.x) \
            if horizon else None
        carry = (state.x, state.x_tilde, t_last, ring, state.generator)
        if knobs is not None:
            carry += (defense_init(t_last.shape[0], t_last.device),)
        rows, drows = [], []
        trows = None if tel is None else []
        for r in range(schedule_arrays[0].shape[0]):
            carry, m = self._round_channel(
                horizon, carry, tuple(a[r] for a in schedule_arrays), tel,
                knobs)
            rows.append(tuple(m[f] for f in SimTrace._fields[:3]))
            if trows is not None:
                trows.append(tuple(m[f] for f in _TEL_COLUMNS))
            if knobs is not None:
                drows.append(tuple(m[f] for f in DefenseTrace._fields))
        x, xt, t_last = carry[:3]
        trace = _finish(_stack_rows(rows, SimTrace), trows)
        if knobs is not None:
            trace = trace._replace(defense=_stack_rows(drows, DefenseTrace))
        return SimState(x, xt, t_last, state.generator), trace

    # ----------------------------------------------- coalesced engine path
    def coalesced_arrays(self, state: SimState, sched: Schedule):
        """Compile a schedule + start clocks into the engine's inputs:
        ``(prologue, partners, dt_next, is_grad, grad_scale, grad_pos,
        t_final, pairs)``.  ``is_grad``, ``grad_pos`` and ``pairs`` (the
        directed pairs each step exchanges, counted before the copy) stay
        host numpy: they steer the loop and label its spans; the rest is
        copied to the device once."""
        return self._stream_arrays(state, sched)[0]

    def _stream_arrays(self, state: SimState, sched: Schedule):
        stream = coalesced_stream(coalesce_schedule(sched),
                                  state.t_last.cpu().numpy())
        partners = np.asarray(stream.partners)
        pairs = (partners != np.arange(partners.shape[1])).sum(axis=1)
        dev = self.device
        return (torch.as_tensor(stream.prologue, device=dev),
                torch.as_tensor(stream.partners, device=dev),
                torch.as_tensor(stream.dt_next, device=dev),
                stream.is_grad, torch.as_tensor(stream.grad_scale,
                                                device=dev),
                stream.grad_pos, torch.as_tensor(stream.t_final,
                                                 device=dev),
                pairs), stream

    def _grad_tick(self, engine: FlatGossipEngine, bx, bxt, generator,
                   gscale, ids, gamma: float | None = None):
        """The engine's gradient tick: the batched gradient on the unpacked
        buffer, the step (``gamma``, default ``self.gamma``) on both buffers
        and the round's metrics row (the trailing mixing segment is the
        caller's).  Spans: ``replay.tick`` over ``replay.grad``,
        ``replay.descend`` and ``replay.row``."""
        n = ids.shape[0]
        with tracing.span("replay.tick"):
            with tracing.span("replay.grad"):
                losses, grads = self.grad_fn(engine.unpack(bx), generator,
                                             ids)
            with tracing.span("replay.descend"):
                bx, bxt = self._descend(engine, bx, bxt, grads, gscale,
                                        self.gamma if gamma is None
                                        else gamma)
            with tracing.span("replay.row"):
                mean = bx.mean(dim=0, keepdim=True)
                # padding columns are zero across workers: they add 0 to
                # both
                row = (losses.mean().float(),
                       (((bx - mean) ** 2).sum() / n).float(),
                       (mean ** 2).sum().float())
        return bx, bxt, row

    def _tail_tick(self, engine: FlatGossipEngine, bx, bxt, generator,
                   gscale, ids, dt_next):
        """The clean replay's gradient tick on the card: the batched
        gradient on the unpacked buffer, then ONE pass for the rest
        (``FlatGossipEngine.tick``: the step on both buffers, the round's
        metrics row and the trailing mixing segment, the buffers written
        in place).  Spans: ``replay.tick`` over ``replay.grad`` and
        ``replay.tail``."""
        with tracing.span("replay.tick"):
            with tracing.span("replay.grad"):
                losses, grads = self.grad_fn(engine.unpack(bx), generator,
                                             ids)
            with tracing.span("replay.tail"):
                # the views grad_fn saw are dead: the pass may write bx
                bx, bxt, consensus, mean_sq = engine.tick(
                    bx, bxt, grads, gscale, self.gamma, dt_next)
                row = (losses.mean().float(), consensus, mean_sq)
        return bx, bxt, row

    @staticmethod
    def _descend(engine: FlatGossipEngine, bx, bxt, grads, gscale,
                 gamma: float):
        """The gradient step on both (W, D) buffers: ``grads`` packed, each
        row scaled by its ``gscale`` (grad_scale masks straggler and
        churned ticks, 1.0 elsewhere), times ``gamma``."""
        g = engine.pack(grads)
        g = gscale[:, None].to(g.dtype) * g
        gamma = dtype_scalar(gamma, g.dtype)
        return bx - gamma * g, bxt - gamma * g

    def run_coalesced(self, state: SimState, stream_arrays
                      ) -> tuple[SimState, SimTrace]:
        """Flat-buffer engine replay of a coalesced event stream (hot path):
        one fused kernel launch per comm step and a batched gradient call
        per gradient tick.  On the card the rest of a tick (step, metrics
        row, trailing mix) is one ``tick_tail_stacked`` pass
        (``_tail_tick``); on the CPU it is ``_grad_tick``'s plain ops and a
        mixing sweep."""
        (prologue, partners, dt_next, is_grad, grad_scale, grad_pos,
         t_final, pairs) = stream_arrays
        engine = FlatGossipEngine.for_pytree(state.x, self.params)
        fused = tree_leaves(state.x)[0].is_cuda
        if tracing.active() is not None:
            _count_call(engine, prologue.shape[0], is_grad, grad_pos,
                        pairs, fused)
        with tracing.span("replay.pack"):
            bx = engine.pack(state.x)
            bxt = engine.pack(state.x_tilde)
        with tracing.span("replay.mix"):
            bx, bxt = engine.mix(bx, bxt, prologue)
        ids = torch.arange(prologue.shape[0], device=bx.device)
        rows = []
        for s in range(len(is_grad)):
            if not is_grad[s]:
                with tracing.span("replay.comm", pairs=pairs[s]):
                    bx, bxt = engine.batch(bx, bxt, partners[s], dt_next[s])
                continue
            if fused:
                bx, bxt, row = self._tail_tick(engine, bx, bxt,
                                               state.generator, grad_scale[s],
                                               ids, dt_next[s])
                rows.append(row)
                continue
            bx, bxt, row = self._grad_tick(engine, bx, bxt, state.generator,
                                           grad_scale[s], ids)
            rows.append(row)
            with tracing.span("replay.mix"):
                bx, bxt = engine.mix(bx, bxt, dt_next[s])
        with tracing.span("replay.unpack"):
            final = SimState(engine.unpack(bx), engine.unpack(bxt), t_final,
                             state.generator)
        # one row per gradient tick, in round order (= grad_pos order)
        return final, _stack_rows(rows, SimTrace)

    def channel_coalesced_arrays(self, state: SimState, sched: Schedule):
        """Engine inputs for a channel schedule + the ring depth H: the
        ``coalesced_arrays`` tuple extended by ``(corrupt, src_slot,
        ring_pos)``.  Staleness offsets resolve to absolute ring slots on
        the host: a step of round r reading s rounds back is served from
        slot ``(r - s) mod H``; the sentinel H means a fresh read.
        ``ring_pos`` (the slot each step's snapshot goes to) stays host
        numpy."""
        arrays, stream = self._stream_arrays(state, sched)
        S, n = stream.partners.shape
        stale, corrupt, horizon = self._channel_extras(stream.extras or {},
                                                       (S, n))
        h = max(horizon, 1)
        # round index per step: a round closes at its gradient tick
        step_round = np.searchsorted(np.asarray(stream.grad_pos),
                                     np.arange(S), side="left")
        src_slot = np.where(stale > 0, (step_round[:, None] - stale) % h,
                            horizon).astype(np.int32)
        ring_pos = (step_round % h).astype(np.int32)
        dev = self.device
        return arrays + (torch.as_tensor(corrupt, device=dev),
                         torch.as_tensor(src_slot, device=dev).long(),
                         ring_pos), horizon

    def run_channel_coalesced(self, state: SimState, stream_arrays,
                              horizon: int, knobs=None,
                              tel: Telemetry | None = None
                              ) -> tuple[SimState, SimTrace]:
        """Flat-buffer engine replay of a channel stream: per comm step the
        partner values are gathered (fresh rows or ring snapshots) and ONE
        channel-kernel launch applies the batch; the ring takes a snapshot
        at each gradient tick.  With defense ``knobs`` the self-healing loop
        runs per fused batch, fed by the kernel's own rejection mask.  With
        a telemetry spec ``tel`` the accumulator folds in each comm step
        (one more delta-norm reduce a step off the defense path) and is
        emitted and reset at each gradient tick, all on the device."""
        (prologue, partners, dt_next, is_grad, grad_scale, grad_pos,
         t_final, pairs, corrupt, src_slot, ring_pos) = stream_arrays
        engine = FlatGossipEngine.for_pytree(state.x, self.params,
                                             robust_clip=self.robust_clip,
                                             robust_rule=self.robust_rule)
        if tracing.active() is not None:
            _count_call(engine, prologue.shape[0], is_grad, grad_pos,
                        pairs)
        with tracing.span("replay.pack"):
            bx = engine.pack(state.x)
            bxt = engine.pack(state.x_tilde)
        with tracing.span("replay.mix"):
            bx, bxt = engine.mix(bx, bxt, prologue)
        n = prologue.shape[0]
        ids = torch.arange(n, device=bx.device)
        ring = ring_init(bx, horizon) if horizon else None
        ds = None if knobs is None else defense_init(n, bx.device)
        acc = None if tel is None else _tel_zeros((), bx.device)
        rows, drows, trows = [], [], []
        for s in range(len(is_grad)):
            if not is_grad[s]:
                with tracing.span("replay.comm", pairs=pairs[s]):
                    partner = partners[s]
                    if horizon:
                        xp = engine.partner_values(ring, bx, partner,
                                                   src_slot[s])
                    else:
                        xp = bx.index_select(0, partner.long())
                    if ds is None:
                        if acc is not None:
                            nrm = engine.delta_norms(bx, xp, corrupt[s])
                            acc = _tel_step(acc, partner != ids,
                                            self._tel_rej(nrm), nrm)
                        bx, bxt = engine.channel_batch(bx, bxt, xp,
                                                       corrupt[s],
                                                       dt_next[s])
                        continue
                    nrm = engine.delta_norms(bx, xp, corrupt[s])
                    involved = partner != ids
                    mscale, quar, ds = defense_comm(knobs, ds, partner,
                                                    involved, nrm)
                    bx, bxt, rej = engine.channel_batch_scaled(
                        bx, bxt, xp, corrupt[s], mscale, dt_next[s])
                    ds = defense_absorb(ds, rej, quar, involved)
                    if acc is not None:
                        acc = _tel_step(acc, involved, rej, nrm)
                continue
            bx, bxt, row = self._grad_tick(engine, bx, bxt, state.generator,
                                           grad_scale[s], ids)
            rows.append(row)
            if acc is not None:
                trows.append(acc)
                acc = _tel_zeros((), bx.device)
            if ds is not None:
                ds, drow = defense_grad(knobs, ds)
                drows.append(drow)
            if horizon:
                ring_push(ring, bx, int(ring_pos[s]))
            with tracing.span("replay.mix"):
                bx, bxt = engine.mix(bx, bxt, dt_next[s])
        with tracing.span("replay.unpack"):
            final = SimState(engine.unpack(bx), engine.unpack(bxt), t_final,
                             state.generator)
        trace = _finish(_stack_rows(rows, SimTrace),
                        None if tel is None else trows)
        if ds is not None:
            trace = trace._replace(defense=_stack_rows(drows, DefenseTrace))
        return final, trace

    def run_world(self, state: SimState, world, rounds: int | None = None,
                  *, seed: int = 0, engine: bool = True
                  ) -> tuple[SimState, SimTrace]:
        """Compile a declarative ``world.World`` and replay it: sugar for
        ``run_schedule(state, world.compile(rounds, seed))`` with the
        world's defense and telemetry spec riding along."""
        return self.run_schedule(state, world.compile(rounds, seed=seed),
                                 engine=engine,
                                 defense=getattr(world, "defense", None),
                                 telemetry=getattr(world, "telemetry", None))

    def run_schedule(self, state: SimState, sched: Schedule, *,
                     engine: bool = True, defense=None,
                     telemetry: Telemetry | None = None,
                     mesh=None) -> tuple[SimState, SimTrace]:
        """Replay a schedule: the engine by default, the per-event path
        with ``engine=False``.  Channel schedules (``stale``/``corrupt``
        extras), robust aggregation and a ``telemetry`` spec take the
        channel twins, an active ``defense`` their self-healing form;
        everything else the plain paths.  With a spec the trace's
        ``telemetry`` is a ``TelemetryTrace``.  On the CPU a tree that no
        flat buffer can hold (e.g. int leaves) takes the per-event path; on
        the card it is refused, so the kernels are never skipped
        quietly.

        With a tracer active (``analysis.tracing``) the call is one
        ``replay.call`` span (args: the flavour, the rounds, and the
        counters of ``_count_call`` on the engine paths) over
        ``replay.compile`` (the host compile of the schedule and its copies
        to the device) and the replay's own spans."""
        if mesh is not None:
            with tracing.span("replay.call", flavour="sharded",
                              rounds=sched.rounds):
                return self._run_schedule_sharded(state, sched, engine,
                                                  defense, telemetry, mesh)
        _check_telemetry(telemetry)
        tel = telemetry
        active = defense is not None and defense.is_active
        if active and self.robust_rule != "trim":
            raise ValueError("the self-healing defense needs "
                             "robust_rule='trim' (its accept/reject loop "
                             f"is binary), got {self.robust_rule!r}")
        if engine:
            try:
                # layout build validates an exact buffer dtype exists
                FlatLayout.from_pytree(state.x, stacked=True)
            except TypeError as err:
                if self.device.type != "cpu":
                    raise NotImplementedError(
                        f"the flat-buffer engine cannot hold this state on "
                        f"{self.device} ({err}); pass engine=False for the "
                        f"per-event replay") from err
                engine = False  # e.g. int leaves: per-event path handles
        extras = sched.extras_dict()
        # a telemetry spec forces the channel flavour, which carries the
        # accumulator: a clean schedule runs it at horizon 0, corrupt 0 and
        # mscale 1, where the channel kernel is the clean one bit for bit
        channel = (active or STALE_KEY in extras or CORRUPT_KEY in extras
                   or self.robust_clip is not None or tel is not None)
        knobs = knobs_single(defense, self.robust_clip, self.device) \
            if active else None
        # schedule columns and row bytes before dispatch: the kernels
        # write x~ in place
        rb = self._row_bytes(state) if tel is not None and tel.bytes_moved \
            else 0
        cols = schedule_columns(tel, sched) if tel is not None else None
        flavour = ("channel_coalesced" if channel else "coalesced") \
            if engine else ("channel" if channel else "event")
        with tracing.span("replay.call", flavour=flavour,
                          rounds=sched.rounds):
            if engine and channel:
                with tracing.span("replay.compile"):
                    arrays, horizon = self.channel_coalesced_arrays(state,
                                                                    sched)
                out = self.run_channel_coalesced(state, arrays, horizon,
                                                 knobs, tel)
            elif engine:
                with tracing.span("replay.compile"):
                    arrays = self.coalesced_arrays(state, sched)
                return self.run_coalesced(state, arrays)
            elif channel:
                with tracing.span("replay.compile"):
                    arrays, horizon = self.channel_reference_arrays(sched)
                out = self.run_channel(state, arrays, horizon, knobs, tel)
            else:
                with tracing.span("replay.compile"):
                    arrays = self.reference_arrays(sched)
                return self.run(state, arrays)
        if tel is None:
            return out
        final, tr = out
        return final, tr._replace(
            telemetry=finalize_trace(tel, tr.telemetry, cols, rb))

    def _run_schedule_sharded(self, state: SimState, sched: Schedule,
                              engine: bool, defense, telemetry, mesh
                              ) -> tuple[SimState, SimTrace]:
        """``run_schedule(mesh=)``: lifted to a B = 1 worlds replay (the
        sharded flavors are world-batched only) with the world axis
        squeezed back off."""
        finalw, trw = self.run_worlds(
            [state], [sched], defenses=None if defense is None else [defense],
            engine=engine, telemetry=telemetry, mesh=mesh)

        def first(v):
            return v[0] if getattr(v, "ndim", 0) >= 1 else v

        def squeeze(t):
            return None if t is None else type(t)(*(first(v) for v in t))

        final = SimState(tree_map(first, finalw.x),
                         tree_map(first, finalw.x_tilde), finalw.t_last[0],
                         finalw.generator[0])
        return final, SimTrace(trw.loss[0], trw.consensus[0],
                               trw.mean_param_norm[0], squeeze(trw.defense),
                               squeeze(trw.telemetry))

    # --------------------------------------------- world-batched replay
    @staticmethod
    def world_params(params_list, device) -> tuple[torch.Tensor, ...]:
        """Per-world (eta, alpha, alpha_tilde) as (B,) f32 tensors on
        ``device``: the kernels read them there.  Rounding each value to
        f32 commutes with the kernels' power-of-two multiplies, and alpha
        goes from f32 to the buffer dtype as a Python float does, so every
        world lands on its serial replay's bits."""
        return tuple(torch.tensor([getattr(p, f) for p in params_list],
                                  dtype=torch.float32, device=device)
                     for f in ("eta", "alpha", "alpha_tilde"))

    @staticmethod
    def batch_states(states) -> SimState:
        """Stack per-world SimStates onto a leading world axis: leaves
        (B, n, ...), t_last (B, n), and the B generators as a tuple (each
        world keeps its own stream)."""
        states = list(states)
        if not states:
            raise ValueError("need at least one state")
        return SimState(
            x=tree_map(lambda *a: torch.stack(a), *[s.x for s in states]),
            x_tilde=tree_map(lambda *a: torch.stack(a),
                             *[s.x_tilde for s in states]),
            t_last=torch.stack([s.t_last for s in states]),
            generator=tuple(s.generator for s in states))

    @staticmethod
    def _world(state: SimState, b: int) -> SimState:
        """World b of a batched state (views, not copies)."""
        return SimState(tree_map(lambda a: a[b], state.x),
                        tree_map(lambda a: a[b], state.x_tilde),
                        state.t_last[b], state.generator[b])

    def _grad_worlds(self, engine: FlatGossipEngine, bx, bxt, generators,
                     gscale, gammas, ids):
        """The batched engine's gradient tick: per world, the serial
        ``_grad_tick`` on its (W, D) rows, with that world's generator and
        step size, written into the (B, W, D) buffers in place.  Returns
        the buffers and the (B,) metrics row."""
        rows = []
        for b in range(bx.shape[0]):
            wx, wxt, row = self._grad_tick(engine, bx[b], bxt[b],
                                           generators[b], gscale[b], ids,
                                           gamma=gammas[b])
            bx[b] = wx
            bxt[b] = wxt
            rows.append(row)
        return bx, bxt, tuple(torch.stack(c) for c in zip(*rows))

    def _batched_stream(self, states: SimState, scheds):
        bs = stack_streams([coalesce_schedule(sc) for sc in scheds],
                           states.t_last.cpu().numpy())
        dev = self.device
        return (torch.as_tensor(bs.prologue, device=dev),
                torch.as_tensor(bs.partners, device=dev),
                torch.as_tensor(bs.dt_next, device=dev),
                bs.is_grad, torch.as_tensor(bs.grad_scale, device=dev),
                bs.grad_pos, torch.as_tensor(bs.t_final, device=dev)), bs

    def worlds_coalesced_arrays(self, states: SimState, scheds):
        """Engine inputs for B schedules: coalesce each world, align the
        streams (``events.stack_streams``), copy to the device; ``is_grad``
        and ``grad_pos`` (shared by every world) stay host numpy."""
        return self._batched_stream(states, scheds)[0]

    def worlds_channel_arrays(self, states: SimState, scheds):
        """Channel twin of ``worlds_coalesced_arrays`` + the shared ring
        depth H, the largest staleness any world demands (a shallower
        world reads the same snapshots from a deeper ring; fresh reads use
        the sentinel H).  Adds ``(corrupt, src_slot, ring_pos)``."""
        arrays, _, _, horizon = self._worlds_channel_stream(states, scheds)
        return arrays, horizon

    def _worlds_channel_stream(self, states: SimState, scheds, mr=None):
        """``worlds_channel_arrays``'s tuple and ring depth, with the
        batched stream and the host (S, B, n) slots.  A sharded replay
        ``mr`` with a positive lag first floors the staleness of every
        cross-shard read (``events.shard_lag_stale``) and deepens the ring
        to hold the lagged window."""
        arrays, bs = self._batched_stream(states, scheds)
        S, B, n = bs.partners.shape
        stale, corrupt, horizon = self._channel_extras(bs.extras_dict(),
                                                       (S, B, n))
        step_round = np.searchsorted(np.asarray(bs.grad_pos), np.arange(S),
                                     side="left")
        if mr is not None and mr.lag > 0 and mr.n_shards > 1:
            stale = shard_lag_stale(bs.partners, stale, step_round,
                                    mr.n_shards, mr.lag)
            horizon = max(horizon, int(stale.max()))
        h = max(horizon, 1)
        src_slot = np.where(stale > 0,
                            (step_round[:, None, None] - stale) % h,
                            horizon).astype(np.int32)
        ring_pos = (step_round % h).astype(np.int32)
        dev = self.device
        return arrays + (torch.as_tensor(corrupt, device=dev),
                         torch.as_tensor(src_slot, device=dev).long(),
                         ring_pos), bs, src_slot, horizon

    def worlds_sharded_arrays(self, states: SimState, scheds, mr):
        """Sharded twin of ``worlds_channel_arrays``: the channel stream
        arrays (cross reads lagged by ``mr.lag``) plus the host-compiled
        shard plan (``events.shard_partition``) for ``mr``'s mesh:
        ``(local_partner, is_cross, hop, pool_pos, pub_row, pub_slot)`` on
        the simulator's device.  Returns ``(arrays, horizon)``."""
        arrays, bs, src_slot, horizon = self._worlds_channel_stream(
            states, scheds, mr)
        plan = shard_partition(bs.partners, src_slot, mr.n_shards, horizon)
        dev = self.device
        return arrays + tuple(torch.as_tensor(a, device=dev) for a in (
            plan.local_partner.astype(np.int64), plan.is_cross,
            plan.hop.astype(np.int64), plan.pool_pos.astype(np.int64),
            plan.pub_row.astype(np.int64),
            plan.pub_slot.astype(np.int64))), horizon

    def worlds_reference_arrays(self, scheds):
        """Batched per-event inputs (``events.stack_schedules``): the
        serial ``reference_arrays`` tuple with a world axis after the
        round axis, K padded with masked identity slots."""
        b = stack_schedules(list(scheds))
        dev = self.device
        return tuple(torch.as_tensor(a, device=dev) for a in (
            b.partners.astype(np.int64), b.event_times, b.event_mask,
            b.grad_times, b.grad_scale, b.alive))

    def worlds_channel_reference_arrays(self, scheds):
        """Batched per-event channel inputs + the shared ring depth (slot
        resolution as in ``worlds_channel_arrays``); ``ring_pos`` (R,)
        stays host numpy."""
        b = stack_schedules(list(scheds))
        R, B, K, n = b.partners.shape
        stale, corrupt, horizon = self._channel_extras(b.extras_dict(),
                                                       (R, B, K, n))
        h = max(horizon, 1)
        rr = np.arange(R)[:, None, None, None]
        src_slot = np.where(stale > 0, (rr - stale) % h,
                            horizon).astype(np.int64)
        ring_pos = (np.arange(R) % h).astype(np.int32)
        dev = self.device
        return tuple(torch.as_tensor(a, device=dev) for a in (
            b.partners.astype(np.int64), b.event_times, b.event_mask,
            src_slot, corrupt, b.grad_times, b.grad_scale, b.alive)) \
            + (ring_pos,), horizon

    def run_worlds_coalesced(self, state: SimState, pw, gammas,
                             stream_arrays) -> tuple[SimState, SimTrace]:
        """World-batched engine replay: one ``mixing_gossip_worlds``
        launch per shared comm step, a per-world gradient tick and one
        batched mixing sweep per gradient step."""
        (prologue, partners, dt_next, is_grad, grad_scale, _grad_pos,
         t_final) = stream_arrays
        engine = FlatGossipEngine.for_pytree(state.x, self.params,
                                             worlds=True)
        bx = engine.pack_worlds(state.x)
        bxt = engine.pack_worlds(state.x_tilde)
        bx, bxt = engine.mix_batch(bx, bxt, prologue, pw[0])
        ids = torch.arange(prologue.shape[1], device=bx.device)
        rows = []
        for s in range(len(is_grad)):
            if not is_grad[s]:
                bx, bxt = engine.batch_worlds(bx, bxt, partners[s],
                                              dt_next[s], pw)
                continue
            bx, bxt, row = self._grad_worlds(engine, bx, bxt,
                                             state.generator, grad_scale[s],
                                             gammas, ids)
            rows.append(row)
            bx, bxt = engine.mix_batch(bx, bxt, dt_next[s], pw[0])
        final = SimState(engine.unpack_worlds(bx), engine.unpack_worlds(bxt),
                         t_final, state.generator)
        return final, _stack_rows(rows, SimTrace, dim=1)

    def run_worlds_channel(self, state: SimState, pw, gammas, taus,
                           stream_arrays, horizon: int, knobs=None,
                           tel: Telemetry | None = None
                           ) -> tuple[SimState, SimTrace]:
        """World-batched channel replay: per shared comm step the partner
        values of every world are gathered (fresh rows or ring snapshots)
        and ONE ``channel_gossip_worlds`` launch applies the batch; every
        world's ring takes a snapshot at each gradient tick.  ``taus``
        ((B,) f32 or None) are per-world robust thresholds; with defense
        ``knobs`` (``defense.knobs_worlds``) the self-healing loop runs on
        a batched state, fed by the kernel's (B, W) rejection mask.  With a
        telemetry spec ``tel`` a (B,) accumulator rides along (rejections
        judged against each world's threshold)."""
        (prologue, partners, dt_next, is_grad, grad_scale, _grad_pos,
         t_final, corrupt, src_slot, ring_pos) = stream_arrays
        engine = FlatGossipEngine.for_pytree(state.x, self.params,
                                             worlds=True,
                                             robust_clip=self.robust_clip,
                                             robust_rule=self.robust_rule)
        bx = engine.pack_worlds(state.x)
        bxt = engine.pack_worlds(state.x_tilde)
        bx, bxt = engine.mix_batch(bx, bxt, prologue, pw[0])
        B, n = prologue.shape
        ids = torch.arange(n, device=bx.device)
        ring = ring_init_worlds(bx, horizon) if horizon else None
        ds = None if knobs is None else defense_init(n, bx.device, batch=B)
        acc = None if tel is None else _tel_zeros((B,), bx.device)
        rows, drows, trows = [], [], []
        for s in range(len(is_grad)):
            if not is_grad[s]:
                xp = engine.partner_values_worlds(ring, bx, partners[s],
                                                  src_slot[s])
                bx, bxt, ds, acc = self._channel_step(
                    engine, bx, bxt, xp, partners[s], ids, corrupt[s],
                    dt_next[s], pw, taus, knobs, ds, acc)
                continue
            bx, bxt, row = self._grad_worlds(engine, bx, bxt,
                                             state.generator, grad_scale[s],
                                             gammas, ids)
            rows.append(row)
            if acc is not None:
                trows.append(acc)
                acc = _tel_zeros((B,), bx.device)
            if ds is not None:
                ds, drow = defense_grad(knobs, ds)
                drows.append(drow)
            if horizon:
                ring_push_worlds(ring, bx, int(ring_pos[s]))
            bx, bxt = engine.mix_batch(bx, bxt, dt_next[s], pw[0])
        final = SimState(engine.unpack_worlds(bx), engine.unpack_worlds(bxt),
                         t_final, state.generator)
        trace = _finish(_stack_rows(rows, SimTrace, dim=1),
                        None if tel is None else trows, dim=1)
        if ds is not None:
            trace = trace._replace(
                defense=_stack_rows(drows, DefenseTrace, dim=1))
        return final, trace

    def _channel_step(self, engine: FlatGossipEngine, bx, bxt, xp, partner,
                      ids, corrupt, dt_next, pw, taus, knobs, ds, acc):
        """One world-batched channel comm step on pre-gathered partner
        values ``xp`` of the (B, W) rows ``ids``: ONE channel-kernel
        launch, with the defense's decision (``knobs``, state ``ds``) or
        the robust thresholds ``taus``, and the telemetry accumulator
        ``acc`` folded in.  Returns (bx, bxt, ds, acc)."""
        involved = partner != ids
        if ds is not None:
            nrm = engine.delta_norms(bx, xp, corrupt, axes=2)
            mscale, quar, ds = defense_comm(knobs, ds, partner, involved,
                                            nrm)
            bx, bxt, rej = engine.channel_batch_worlds_scaled(
                bx, bxt, xp, corrupt, mscale, dt_next, pw)
            ds = defense_absorb(ds, rej, quar, involved)
        else:
            if acc is not None:
                nrm = engine.delta_norms(bx, xp, corrupt, axes=2)
                rej = self._tel_rej(nrm, taus)
            bx, bxt = engine.channel_batch_worlds(bx, bxt, xp, corrupt,
                                                  dt_next, pw, taus)
        if acc is not None:
            acc = _tel_step(acc, involved, rej, nrm, batched=True)
        return bx, bxt, ds, acc

    def _run_worlds_per_event(self, state: SimState, scheds, plan
                              ) -> tuple[SimState, SimTrace]:
        """The per-event oracle: world b's serial per-event replay, with its
        own params, step size, threshold and defense knobs, on row b of the
        padded batched schedule arrays; the results stacked."""
        if plan["channel"]:
            arrays, horizon = self.worlds_channel_reference_arrays(scheds)
        else:
            arrays = self.worlds_reference_arrays(scheds)
        outs = []
        for b in range(len(scheds)):
            sim = dataclasses.replace(self, params=plan["params"][b],
                                      gamma=plan["gammas"][b],
                                      robust_clip=plan["taus"][b])
            st = self._world(state, b)
            if not plan["channel"]:
                outs.append(sim.run(st, tuple(a[:, b] for a in arrays)))
                continue
            knobs = knobs_single(plan["defenses"][b], plan["taus"][b],
                                 self.device) if plan["active"] else None
            outs.append(sim.run_channel(
                st, tuple(a[:, b] for a in arrays[:-1]) + arrays[-1:],
                horizon, knobs, plan["tel"]))
        final = self.batch_states([f for f, _ in outs])
        traces = [t for _, t in outs]
        trace = SimTrace(*(torch.stack([getattr(t, k) for t in traces])
                           for k in ("loss", "consensus", "mean_param_norm")))
        if plan["tel"] is not None:
            trace = trace._replace(telemetry=tuple(
                torch.stack(c) for c in zip(*(t.telemetry for t in traces))))
        if plan["active"]:
            trace = trace._replace(defense=DefenseTrace(
                *(torch.stack(c) for c in zip(*(t.defense for t in traces)))))
        return final, trace

    def _worlds_plan(self, states: SimState, scheds, *, params, gammas,
                     robust_clips, defenses, worlds, telemetry) -> dict:
        """Validate a worlds call and derive each world's knobs: params
        (explicit, else each world's ``algorithm_params()`` where it
        declares an algorithm, else ``self.params``), step sizes,
        thresholds (None entries fall back to ``self.robust_clip``),
        defense arms (explicit, else the worlds' ``defense`` fields) and
        the telemetry spec (explicit, else the one spec the worlds
        declare).  Any active defense routes the whole batch to the defense
        flavor, whose inactive arms run neutral knobs (their static
        arithmetic); a spec forces the channel flavor."""
        B = len(scheds)
        lead = tree_leaves(states.x)[0].shape[0]
        if lead != B:
            raise ValueError(f"states are batched for {lead} worlds but "
                             f"{B} schedules were given")
        if worlds is not None:
            wlist = list(worlds)
            if len(wlist) != B:
                raise ValueError(f"worlds must have one entry per schedule "
                                 f"({B}), got {len(wlist)}")
            if params is None:
                params = [self.params if w.algorithm is None
                          else w.algorithm_params() for w in wlist]
            if defenses is None and any(w.defense is not None
                                        for w in wlist):
                defenses = [w.defense for w in wlist]
            if telemetry is None:
                tspecs = {w.telemetry for w in wlist
                          if w.telemetry is not None}
                if len(tspecs) > 1:
                    raise ValueError(
                        "worlds declare multiple distinct Telemetry specs; "
                        "a batch shares ONE spec")
                if tspecs:
                    telemetry = next(iter(tspecs))
        _check_telemetry(telemetry)

        def per_world(name, values, default):
            out = list(values) if values is not None else [default] * B
            if len(out) != B:
                raise ValueError(f"{name} must have one entry per world "
                                 f"({B}), got {len(out)}")
            return out

        plist = per_world("params", params, self.params)
        glist = [float(g) for g in per_world("gammas", gammas, self.gamma)]
        taus = [self.robust_clip if c is None else float(c)
                for c in per_world("robust_clips", robust_clips, None)]
        dlist = per_world("defenses", defenses, None)
        active = any(d is not None and d.is_active for d in dlist)
        any_clip = robust_clips is not None
        if (active or any_clip) and self.robust_rule == "coord":
            raise ValueError("per-world thresholds and the self-healing "
                             "defense need a norm rule ('trim' or "
                             "'clip'), not 'coord'")
        if active and self.robust_rule != "trim":
            raise ValueError("the self-healing defense needs "
                             "robust_rule='trim' (its accept/reject loop "
                             f"is binary), got {self.robust_rule!r}")
        channel = (active or any_clip or self.robust_clip is not None
                   or telemetry is not None
                   or any(STALE_KEY in sc.extras_dict()
                          or CORRUPT_KEY in sc.extras_dict()
                          for sc in scheds))
        return dict(params=plist, gammas=glist, taus=taus, defenses=dlist,
                    active=active, any_clip=any_clip, channel=channel,
                    tel=telemetry)

    def run_worlds(self, states, scheds, *, params=None, gammas=None,
                   robust_clips=None, defenses=None, worlds=None,
                   engine: bool = True, telemetry=None, mesh=None
                   ) -> tuple[SimState, SimTrace]:
        """Replay B independent worlds at once.

        states — a list of per-world SimStates (stacked with
          ``batch_states``) or a world-batched SimState.
        scheds — B compiled schedules sharing (rounds, n), e.g.
          ``WorldSweep(...).compile(rounds)``; ragged event counts are
          padded with identity groups (exact no-ops).
        params / gammas / robust_clips / defenses — optional per-world
          ``A2CiD2Params``, step sizes, robust thresholds and
          ``AdaptiveDefense | None`` arms (see ``_worlds_plan``);
          ``worlds`` — optional B ``World`` specs the params and defenses
          are derived from where not given.

        telemetry — optional ``telemetry.Telemetry`` spec (or the one spec
          the ``worlds`` declare): the trace's ``telemetry`` is then a
          ``TelemetryTrace`` of (B, rounds) columns.

        Returns the world-batched final state and a SimTrace of (B, rounds)
        tensors: row b is world b's serial replay.  Dispatch mirrors
        ``run_schedule``: channel extras, thresholds, a telemetry spec or a
        defense select the channel flavor, an active defense its
        self-healing form; ``engine=False`` the per-event oracle.  On the
        CPU a state no flat buffer can hold takes the per-event path; on
        the card it is refused.

        mesh — a ``launch.mesh_replay.MeshReplay`` (or a bare replay mesh,
          at lag 0): the sharded replay, the worker axis split over the
          mesh's shards (``launch/mesh_replay.py``).  Every flavor runs as
          the channel flavor there (bit for bit the plain one on a clean
          schedule).  A worker axis the mesh cannot split evenly warns and
          replays on one device; ``engine=False`` is refused; a telemetry
          spec with ``shards`` 0 takes the mesh's shard count.
        """
        fn, args = self.worlds_executable(
            states, scheds, params=params, gammas=gammas,
            robust_clips=robust_clips, defenses=defenses, worlds=worlds,
            engine=engine, telemetry=telemetry, mesh=mesh)
        return fn(*args)

    def worlds_executable(self, states, scheds, *, params=None,
                          gammas=None, robust_clips=None, defenses=None,
                          worlds=None, engine: bool = True, telemetry=None,
                          mesh=None):
        """The callable and argument tuple a ``run_worlds`` call with the
        same arguments dispatches, the host side (batching, the stream
        arrays, the shard plan, the telemetry schedule columns) already
        done: ``fn(*args)`` is that call, bit for bit.  ``fn`` is the
        flavor's replay method, or ``launch.mesh_replay.sharded_replay``
        with ``mesh=``; with a telemetry spec it is wrapped to finish the
        trace's columns.  Nothing is donated (the port's replays pack the
        state into fresh buffers); each call draws from
        ``states.generator``."""
        scheds = list(scheds)
        if not isinstance(states, SimState):
            states = self.batch_states(states)
        plan = self._worlds_plan(states, scheds, params=params,
                                 gammas=gammas, robust_clips=robust_clips,
                                 defenses=defenses, worlds=worlds,
                                 telemetry=telemetry)
        mr = None if mesh is None else self._replay_mesh(mesh, states, plan,
                                                         engine)
        tel = plan["tel"]
        # schedule columns and row bytes before dispatch (the kernels write
        # x~ in place)
        rb = self._row_bytes(states, worlds=True) \
            if tel is not None and tel.bytes_moved else 0
        cols = batch_schedule_columns(tel, scheds) if tel is not None \
            else None
        if mr is not None:
            fn, args = self._sharded_worlds(states, scheds, plan, mr)
        else:
            fn, args = self._dispatch_worlds(states, scheds, plan, engine)
        if tel is None:
            return fn, args

        def with_columns(*a):
            """The replay, its telemetry finished with the schedule
            columns and row bytes."""
            final, trace = fn(*a)
            return final, trace._replace(
                telemetry=finalize_trace(tel, trace.telemetry, cols, rb))

        return with_columns, args

    def _dispatch_worlds(self, states: SimState, scheds, plan: dict,
                         engine: bool) -> tuple:
        """(flavor, arguments) of a single-device worlds replay."""
        if engine:
            try:
                FlatLayout.from_pytree(states.x, worlds=True)
            except TypeError as err:
                if self.device.type != "cpu":
                    raise NotImplementedError(
                        f"the flat-buffer engine cannot hold this state on "
                        f"{self.device} ({err}); pass engine=False for the "
                        f"per-event replay") from err
                engine = False
        if not engine:
            return self._run_worlds_per_event, (states, scheds, plan)
        pw = self.world_params(plan["params"], self.device)
        gammas, tel = plan["gammas"], plan["tel"]
        if plan["active"]:
            arrays, horizon = self.worlds_channel_arrays(states, scheds)
            return self.run_worlds_channel, (states, pw, gammas, None,
                                             arrays, horizon,
                                             self._knobs(plan), tel)
        if plan["channel"]:
            arrays, horizon = self.worlds_channel_arrays(states, scheds)
            return self.run_worlds_channel, (states, pw, gammas,
                                             self._taus(plan), arrays,
                                             horizon, None, tel)
        return self.run_worlds_coalesced, (
            states, pw, gammas, self.worlds_coalesced_arrays(states, scheds))

    def _knobs(self, plan: dict):
        """The defense flavor's (B,) knobs, None off it."""
        if not plan["active"]:
            return None
        return knobs_worlds(plan["defenses"], plan["taus"], self.device)

    def _taus(self, plan: dict) -> torch.Tensor | None:
        """Per-world (B,) thresholds for the channel flavor when the call
        gave any (None entries accept every finite delta); None otherwise
        and on the defense flavor, whose knobs carry them."""
        if plan["active"] or not plan["any_clip"]:
            return None
        return torch.tensor([float("inf") if t is None else t
                             for t in plan["taus"]],
                            dtype=torch.float32, device=self.device)

    def _replay_mesh(self, mesh, states: SimState, plan: dict,
                     engine: bool):
        """Validate ``run_worlds(mesh=)``: the ``MeshReplay``, or None when
        the worker axis cannot be split evenly (after a warning: the
        replay then runs on one device).  A telemetry spec with ``shards``
        0 takes the mesh's shard count in ``plan``."""
        from ..launch.mesh_replay import MeshReplay
        mr = mesh if isinstance(mesh, MeshReplay) else MeshReplay(mesh)
        if engine:
            try:
                FlatLayout.from_pytree(states.x, worlds=True)
            except TypeError:
                engine = False
        if not engine:
            raise ValueError(
                "the sharded replay (mesh=) runs on the flat-buffer engine; "
                "engine=False (or a layout-rejected pytree) has no worker "
                "banks to shard")
        n = states.t_last.shape[1]
        if n % mr.n_shards != 0:
            warnings.warn(f"worker axis {n} is not divisible by "
                          f"{mr.n_shards} shards; falling back to the "
                          f"single-device replay", RuntimeWarning,
                          stacklevel=3)
            return None
        if mr.n_shards > 1 and not isinstance(self.grad_fn, SplitGradFn):
            raise ValueError(
                "the sharded replay needs a grad_fn with a draw / apply "
                "split (simulator.SplitGradFn): each shard draws the whole "
                "world's batch and applies its own rows, and a plain "
                "callable would draw a different batch on every shard")
        tel = plan["tel"]
        if tel is not None and tel.shards == 0:
            plan["tel"] = dataclasses.replace(tel, shards=mr.n_shards)
        return mr

    def _sharded_worlds(self, states: SimState, scheds, plan: dict, mr
                        ) -> tuple:
        """(``sharded_replay``, arguments): the channel flavor (its defense
        form on an active defense) on the mesh's shards,
        ``launch.mesh_replay``."""
        from ..launch.mesh_replay import sharded_replay
        arrays, horizon = self.worlds_sharded_arrays(states, scheds, mr)
        return sharded_replay, (
            self, states, self.world_params(plan["params"], self.device),
            plan["gammas"], self._taus(plan), self._knobs(plan), arrays,
            horizon, plan["tel"], mr)


# --------------------------------------------------------------- AR-SGD ref

def allreduce_sgd(grad_fn: GradFn, gamma: float, x0: PyTree, n: int,
                  rounds: int, generator: torch.Generator,
                  device: Any = "cuda") -> tuple[PyTree, torch.Tensor]:
    """Synchronous All-Reduce SGD baseline (the paper's AR-SGD): per round
    one batched ``grad_fn`` call for all n workers, the gradients averaged
    over the workers, and every replica steps by ``gamma`` times the mean.
    Returns worker 0's params and the (rounds,) mean losses.  The mean is
    JAX's: a sum at f32 or wider, divided, rounded once to the gradient's
    dtype."""
    dev = resolve_device(device)

    def stack(a):
        a = torch.as_tensor(a, device=dev)
        return a.unsqueeze(0).expand((n,) + a.shape).contiguous()

    def step(p, g):
        acc = g.to(torch.promote_types(g.dtype, torch.float32))
        mean = (acc.sum(dim=0, keepdim=True) / n).to(g.dtype)
        return p - dtype_scalar(gamma, g.dtype) * mean

    x = tree_map(stack, x0)
    ids = torch.arange(n, device=dev)
    losses = []
    for _ in range(rounds):
        loss, grads = grad_fn(x, generator, ids)
        x = tree_map(step, x, grads)
        losses.append(loss.mean())
    return tree_map(lambda a: a[0], x), torch.stack(losses)
