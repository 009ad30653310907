"""Discrete-event simulator of Algorithm 1, plain flavor.

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
    launch of the Hopper kernel on the packed (n, D) buffers.

The JAX ``lax.scan``/``lax.cond`` become a host loop over the precomputed
stream.  ``is_grad`` stays on the host, the per-step partners and mixing
horizons are copied to the device once, and the per-round metrics stay on
the device until the replay ends, so the loop never waits for the card.
The unreliable-channel, defense, telemetry and sharded flavors are not
ported yet; ``run_schedule`` refuses them instead of taking another path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..device import resolve_device
from .a2cid2 import (A2CiD2Params, apply_mixing, consensus_distance,
                     matched_p2p_update, worker_mean)
from .engine import FlatGossipEngine
from .events import Schedule, coalesce_schedule, coalesced_stream
from .flatbuf import FlatLayout
from .tree import PyTree, tree_leaves, tree_map

# grad_fn(x_stacked, generator, worker_ids) -> (losses (n,), grads) for ALL
# workers at once: ``x_stacked`` is the state pytree with leaves (n, ...),
# ``worker_ids`` the (n,) int64 ids on the state's device, ``grads`` a pytree
# like ``x_stacked``.  Randomness (each worker's data draw) comes from
# ``generator``.  The JAX package vmaps a per-worker function over split
# keys instead; torch generators do not split, so the port batches here.
GradFn = Callable[[PyTree, torch.Generator, torch.Tensor],
                  tuple[torch.Tensor, PyTree]]

_CHANNEL_KEYS = ("stale", "corrupt")


class SimState(NamedTuple):
    x: PyTree                    # leaves (n, ...)
    x_tilde: PyTree              # leaves (n, ...)
    t_last: torch.Tensor         # (n,) f32 last per-worker event time
    generator: torch.Generator   # randomness of the gradient ticks


class SimTrace(NamedTuple):
    loss: torch.Tensor             # (rounds,) mean worker loss
    consensus: torch.Tensor        # (rounds,) ||pi x||^2 / n
    mean_param_norm: torch.Tensor  # (rounds,)


@dataclasses.dataclass(frozen=True)
class Simulator:
    grad_fn: GradFn
    params: A2CiD2Params
    gamma: float
    robust_clip: float | None = None
    device: Any = "cuda"   # the card unless the caller names the CPU

    def __post_init__(self):
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

    def run(self, state: SimState, schedule_arrays
            ) -> tuple[SimState, SimTrace]:
        """Per-event reference replay (unfused, sweeps masked slots too)."""
        partners, times, mask, grad_times, grad_scale, alive = schedule_arrays
        x, xt, t_last = state.x, state.x_tilde, state.t_last
        n = t_last.shape[0]
        ids = torch.arange(n, device=t_last.device)
        rows = []
        for r in range(partners.shape[0]):
            for k in range(partners.shape[1]):
                partner, time = partners[r, k], times[r, k]
                involved = (partner != ids) & mask[r, k]
                dt = torch.where(involved, time - t_last, 0.0)
                x, xt = apply_mixing(x, xt, self.params.eta, dt)
                t_last = torch.where(involved, time, t_last)
                x, xt = matched_p2p_update(x, xt, partner, self.params)
            # detached workers neither advance their clock nor mix;
            # stragglers advance and mix but skip the gradient
            dt = torch.where(alive[r], grad_times[r] - t_last, 0.0)
            x, xt = apply_mixing(x, xt, self.params.eta, dt)
            losses, grads = self.grad_fn(x, state.generator, ids)
            s = grad_scale[r]

            def upd(p, g):
                sc = s.reshape(s.shape + (1,) * (g.dim() - 1)).to(g.dtype)
                return p - self.gamma * (sc * g)

            x, xt = tree_map(upd, x, grads), tree_map(upd, xt, grads)
            t_last = torch.where(alive[r], grad_times[r], t_last)
            rows.append((losses.mean().float(),
                         consensus_distance(x).float(),
                         sum((m ** 2).sum() for m in
                             tree_leaves(worker_mean(x))).float()))
        return (SimState(x, xt, t_last, state.generator),
                SimTrace(*(torch.stack(c) for c in zip(*rows))))

    # ----------------------------------------------- coalesced engine path
    def coalesced_arrays(self, state: SimState, sched: Schedule):
        """Compile a schedule + start clocks into the engine's inputs:
        ``(prologue, partners, dt_next, is_grad, grad_scale, grad_pos,
        t_final)``.  ``is_grad`` and ``grad_pos`` stay host numpy (they
        steer the loop); the rest is copied to the device once."""
        stream = coalesced_stream(coalesce_schedule(sched),
                                  state.t_last.cpu().numpy())
        dev = self.device
        return (torch.as_tensor(stream.prologue, device=dev),
                torch.as_tensor(stream.partners, device=dev),
                torch.as_tensor(stream.dt_next, device=dev),
                stream.is_grad, torch.as_tensor(stream.grad_scale,
                                                device=dev),
                stream.grad_pos, torch.as_tensor(stream.t_final, device=dev))

    def run_coalesced(self, state: SimState, stream_arrays
                      ) -> tuple[SimState, SimTrace]:
        """Flat-buffer engine replay of a coalesced event stream (hot path):
        one fused kernel launch per comm step, a batched gradient call and
        a plain mixing sweep per gradient tick."""
        (prologue, partners, dt_next, is_grad, grad_scale, _grad_pos,
         t_final) = stream_arrays
        engine = FlatGossipEngine.for_pytree(state.x, self.params)
        bx = engine.pack(state.x)
        bxt = engine.pack(state.x_tilde)
        bx, bxt = engine.mix(bx, bxt, prologue)
        n = prologue.shape[0]
        ids = torch.arange(n, device=bx.device)
        rows = []
        for s in range(len(is_grad)):
            if not is_grad[s]:
                bx, bxt = engine.batch(bx, bxt, partners[s], dt_next[s])
                continue
            losses, grads = self.grad_fn(engine.unpack(bx), state.generator,
                                         ids)
            g = engine.pack(grads)
            # grad_scale masks straggler/churned ticks (1.0 elsewhere)
            g = grad_scale[s][:, None].to(g.dtype) * g
            bx = bx - self.gamma * g
            bxt = bxt - self.gamma * g
            mean = bx.mean(dim=0, keepdim=True)
            # padding columns are zero across workers: they add 0 to both
            rows.append((losses.mean().float(),
                         (((bx - mean) ** 2).sum() / n).float(),
                         (mean ** 2).sum().float()))
            bx, bxt = engine.mix(bx, bxt, dt_next[s])
        final = SimState(engine.unpack(bx), engine.unpack(bxt), t_final,
                         state.generator)
        # one row per gradient tick, in round order (= grad_pos order)
        return final, SimTrace(*(torch.stack(c) for c in zip(*rows)))

    def run_schedule(self, state: SimState, sched: Schedule, *,
                     engine: bool = True, defense=None, telemetry=None,
                     mesh=None) -> tuple[SimState, SimTrace]:
        """Replay a schedule: the engine by default, the per-event path
        with ``engine=False``.  On the CPU a tree that no flat buffer can
        hold (e.g. int leaves) takes the per-event path; on the card it is
        refused, so the kernel is never skipped quietly."""
        missing = [(mesh is not None, "mesh=... (the sharded replay)"),
                   (defense is not None, "defense=... (the defense slice)"),
                   (telemetry is not None,
                    "telemetry=... (the telemetry slice)"),
                   (self.robust_clip is not None,
                    "robust_clip (the unreliable-channel slice)"),
                   (any(k in sched.extras_dict() for k in _CHANNEL_KEYS),
                    "channel extras 'stale'/'corrupt' (the "
                    "unreliable-channel slice)")]
        for hit, what in missing:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported to PyTorch yet")
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
        if engine:
            return self.run_coalesced(state,
                                      self.coalesced_arrays(state, sched))
        return self.run(state, self.reference_arrays(sched))
