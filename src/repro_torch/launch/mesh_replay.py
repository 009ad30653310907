"""Sharded worlds replay: the worker axis of the flat gossip banks split
over a replay mesh (``launch/mesh.py``).

``Simulator.run_worlds(..., mesh=MeshReplay(mesh))`` replays the SAME
batched streams the single-device engine consumes, but each shard holds
its own (B, W / NS, D) banks and (B, H, W / NS, D) snapshot ring, and
every channel-kernel launch runs on one shard's rows.  One operation
crosses a shard boundary: the partner-value fetch of a cross-shard pair,
served by the bounded-staleness permute ring —

  * the host shard compiler (``events.shard_partition``) splits each
    step's matching into intra-shard pairs and cross-shard boundary
    reads, and lists the local rows each shard must publish at each step;
  * at every comm step each shard resolves its published rows against its
    OWN snapshot ring (``FlatGossipEngine.publish_rows``: the publisher
    applies the read's scheduled staleness, so the value that crosses is
    bit for bit the single-device ``ring_read_worlds``), one gather over
    the shards stacks the blocks into a hop-ordered pool
    (``flatbuf.ring_pool_exchange``), and readers index it by (hop, pos);
  * ``MeshReplay.lag > 0`` floors the staleness of every cross-shard read
    at ``lag`` rounds (``events.shard_lag_stale``): the lag-L sharded
    replay is bit for bit the single-device replay of
    ``world.shard_lag_schedule(sched, NS, L)``.

Why the final state is BITWISE the single-device replay at lag 0: the
flat layout is row-independent, every kernel pass and gather is row-local,
the delta norms are summed in blocks of a fixed row count
(``FlatGossipEngine.delta_norms``),
cross-shard values are exact copies, the defense's per-world estimator
sees the gathered records, and every shard draws the whole world's batch
(``simulator.SplitGradFn``) and applies its own rows.  Only the trace
metrics (loss, consensus, mean norm) and the telemetry moments cross the
shards as sums of partials: they reassociate, and never feed the state.

The replay is the port's host loop over the stream's steps, as
``Simulator.run_worlds_channel``; there is no compiled scan, so the JAX
package's ``sharded_twin`` (its jitted scan and trace cache) has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.defense import (DefenseKnobs, DefenseTrace, defense_grad,
                            defense_init)
from ..core.engine import FlatGossipEngine
from ..core.flatbuf import (ring_init_worlds, ring_pool_exchange,
                            ring_push_worlds)
from ..core.simulator import (SimState, SimTrace, SplitGradFn, _finish,
                              _stack_rows, _tel_zeros)
from ..core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class MeshReplay:
    """Sharded-replay spec: a 1-D replay mesh with a worker axis, plus the
    permute ring's staleness lag.

    lag — staleness floor (in rounds) on cross-shard partner reads.
      0 = per-step boundary exchange, bitwise the single-device engine;
      L > 0 = boundary reads ride snapshots >= L rounds old, exactly a
      ``ChannelModel(delay=...)`` on the boundary edges.
    """

    mesh: Any
    lag: int = 0
    axis: str = "worker"

    def __post_init__(self):
        if not hasattr(self.mesh, "axis_names"):
            raise TypeError(f"mesh must be a replay mesh (launch.mesh), got "
                            f"{type(self.mesh).__name__}")
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no {self.axis!r} axis "
                             f"(axes: {self.mesh.axis_names})")
        if self.lag < 0:
            raise ValueError(f"lag must be >= 0, got {self.lag}")

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def place_states(self, states: SimState) -> list[SimState]:
        """The rows of this process's shards of a world-batched SimState:
        per shard (in ``mesh.shards`` order) its (B, n / NS, ...) leaves
        and (B, n / NS) clocks on its device (views where it is the
        state's device).  The generators are shared: every shard draws the
        whole world's batch from them."""
        ws = states.t_last.shape[1] // self.n_shards
        out = []
        for u, dev in zip(self.mesh.shards, self.mesh.devices):
            def rows(a, u=u, dev=dev):
                return a[:, u * ws:(u + 1) * ws].to(dev)
            out.append(SimState(tree_map(rows, states.x),
                                tree_map(rows, states.x_tilde),
                                rows(states.t_last), states.generator))
        return out


class _Shard:
    """One shard's banks, ring, defense state and telemetry accumulator,
    with its columns of the stream arrays on its device."""

    def __init__(self, u, dev, ws, state, engine, arrays, pw, taus, knobs,
                 horizon, tel, n):
        (prologue, partners, dt_next, _is_grad, grad_scale, _grad_pos,
         _t_final, corrupt, src_slot, _ring_pos, lpart, cross, hop, ppos,
         pub_row, pub_slot) = arrays
        self.dev = dev
        self.cols = slice(u * ws, (u + 1) * ws)

        def mine(a):   # (..., n) -> this shard's contiguous columns
            return a[..., self.cols].contiguous().to(dev)

        self.wid = torch.arange(u * ws, (u + 1) * ws, device=dev)
        (self.partners, self.dt_next, self.grad_scale, self.corrupt,
         self.src_slot, self.lpart, self.cross, self.hop, self.ppos) = map(
            mine, (partners, dt_next, grad_scale, corrupt, src_slot, lpart,
                   cross, hop, ppos))
        self.pub_row = pub_row[:, u].contiguous().to(dev)
        self.pub_slot = pub_slot[:, u].contiguous().to(dev)
        self.pw = tuple(p.to(dev) for p in pw)
        self.taus = None if taus is None else taus.to(dev)
        self.knobs = None if knobs is None else DefenseKnobs(
            *(k.to(dev) for k in knobs))
        b = prologue.shape[0]
        self.bx = engine.pack_worlds(state.x).to(dev)
        self.bxt = engine.pack_worlds(state.x_tilde).to(dev)
        self.bx, self.bxt = engine.mix_batch(self.bx, self.bxt,
                                             mine(prologue), self.pw[0])
        self.ring = ring_init_worlds(self.bx, horizon) if horizon else None
        self.ds = None if knobs is None else defense_init(n, dev, batch=b,
                                                          rows=ws)
        self.acc = None if tel is None else _tel_zeros((b,), dev)


def _comm(sim, engine, sh: _Shard, s: int, pool: torch.Tensor) -> None:
    """One comm step on one shard: the local gather merged with the pool's
    cross reads, then ``Simulator._channel_step`` on the shard's rows (ONE
    channel-kernel launch)."""
    xp = engine.partner_values_worlds(sh.ring, sh.bx, sh.lpart[s],
                                      sh.src_slot[s])
    xp = engine.pool_partner_values(pool, sh.hop[s], sh.ppos[s], xp,
                                    sh.cross[s])
    sh.bx, sh.bxt, sh.ds, sh.acc = sim._channel_step(
        engine, sh.bx, sh.bxt, xp, sh.partners[s], sh.wid, sh.corrupt[s],
        sh.dt_next[s], sh.pw, sh.taus, sh.knobs, sh.ds, sh.acc)


def _grad_worlds_sharded(sim, engine, mesh, shards, generators, s: int,
                         gammas, n: int) -> tuple:
    """Sharded twin of ``Simulator._grad_worlds``: per world, the whole
    world's batch is drawn once from its generator and every shard applies
    its own rows (so per-worker gradient noise is bitwise the single-device
    stream), then the step on both banks.  The trace metrics are sums of
    per-shard f32 partials over the mesh, rounded to the buffer (loss)
    dtype as the single-device means are."""
    split = isinstance(sim.grad_fn, SplitGradFn)
    batches = [sim.grad_fn.draw(g, n) for g in generators] if split \
        else None
    loss_parts, loss_dtype = [], None
    for sh in shards:
        part = []
        for b, gen in enumerate(generators):
            x_rows = engine.unpack(sh.bx[b])
            if split:
                rows = tree_map(lambda a: a[sh.cols].to(sh.dev), batches[b])
                losses, grads = sim.grad_fn.apply(x_rows, rows, sh.wid)
            else:   # one shard: the whole world, the single-device call
                losses, grads = sim.grad_fn(x_rows, gen, sh.wid)
            sh.bx[b], sh.bxt[b] = sim._descend(engine, sh.bx[b], sh.bxt[b],
                                               grads, sh.grad_scale[s, b],
                                               gammas[b])
            part.append(losses.sum(dtype=torch.float32))
            loss_dtype = losses.dtype
        loss_parts.append(torch.stack(part))
    dtype = shards[0].bx.dtype
    means = [(m / n).to(dtype) for m in mesh.sum(
        [sh.bx.sum(dim=1, dtype=torch.float32) for sh in shards])]
    cons = mesh.sum([((sh.bx - m[:, None]) ** 2).sum(dim=(1, 2),
                                                     dtype=torch.float32)
                     for sh, m in zip(shards, means)])
    loss = mesh.sum(loss_parts)[0]
    mean = means[0]
    return ((loss / n).to(loss_dtype).float(),
            (cons[0] / n).to(dtype).float(),
            (mean ** 2).sum(dim=1).float())


def _defense_grad_sharded(mesh, shards, b: int, n: int, ws: int):
    """The gradient-tick controller on every shard: ``defense_grad`` sees
    the round's records gathered over the shards and the round counters
    summed (exact: they count events), so the replicated estimator stays
    identical on every shard; each shard then resets its own rows.
    Returns the (tau, rejections, quarantined) trace row."""
    recs = mesh.all_gather([torch.stack([sh.ds.lastn, sh.ds.lastv.float()])
                            for sh in shards])          # (NS, 2, B, Ws)
    accs = mesh.sum([torch.stack([sh.ds.rej_acc, sh.ds.quar_acc])
                     for sh in shards])                 # (2, B)
    row = None
    for sh, rec, acc in zip(shards, recs, accs):
        full = rec.permute(1, 2, 0, 3).reshape(2, b, n)
        ds, out = defense_grad(sh.knobs, sh.ds._replace(
            lastn=full[0], lastv=full[1] > 0, rej_acc=acc[0],
            quar_acc=acc[1]))
        sh.ds = ds._replace(
            lastn=torch.zeros((b, ws), dtype=torch.float32, device=sh.dev),
            lastv=torch.zeros((b, ws), dtype=torch.bool, device=sh.dev))
        row = out if row is None else row
    return row


def sharded_replay(sim, states: SimState, pw, gammas, taus, knobs, arrays,
                   horizon: int, tel, mr: MeshReplay
                   ) -> tuple[SimState, SimTrace]:
    """The sharded channel replay (its defense form with ``knobs``):
    ``Simulator.run_worlds_channel`` with the worker axis split over
    ``mr``'s shards.  ``arrays`` is ``Simulator.worlds_sharded_arrays``'s
    tuple: the channel stream arrays followed by the shard plan.  The
    final state is gathered from every shard (every rank of a rank mesh
    holds the whole world's state); the trace is the first local shard's
    (every shard holds the same sums)."""
    mesh = mr.mesh
    prologue, is_grad, ring_pos, t_final = (arrays[0], arrays[3],
                                            arrays[9], arrays[6])
    b, n = prologue.shape
    ws = n // mr.n_shards
    engine = FlatGossipEngine.for_pytree(states.x, sim.params, worlds=True,
                                         robust_clip=sim.robust_clip,
                                         robust_rule=sim.robust_rule)
    shards = [_Shard(u, dev, ws, st, engine, arrays, pw, taus, knobs,
                     horizon, tel, n)
              for u, dev, st in zip(mesh.shards, mesh.devices,
                                    mr.place_states(states))]
    home = sim.device
    rows, drows, trows = [], [], []
    for s in range(len(is_grad)):
        if not is_grad[s]:
            # every shard publishes before any shard updates its banks
            pools = ring_pool_exchange(
                [engine.publish_rows(sh.ring, sh.bx, sh.pub_row[s],
                                     sh.pub_slot[s]) for sh in shards], mesh)
            for sh, pool in zip(shards, pools):
                _comm(sim, engine, sh, s, pool)
            continue
        row = _grad_worlds_sharded(sim, engine, mesh, shards,
                                   states.generator, s, gammas, n)
        rows.append(tuple(v.to(home) for v in row))
        if tel is not None:
            acc = mesh.sum([torch.stack(sh.acc) for sh in shards])[0]
            trows.append(tuple(acc.to(home)))
            for sh in shards:
                sh.acc = _tel_zeros((b,), sh.dev)
        if knobs is not None:
            drow = _defense_grad_sharded(mesh, shards, b, n, ws)
            drows.append(tuple(v.to(home) for v in drow))
        for sh in shards:
            if sh.ring is not None:
                ring_push_worlds(sh.ring, sh.bx, int(ring_pos[s]))
            sh.bx, sh.bxt = engine.mix_batch(sh.bx, sh.bxt, sh.dt_next[s],
                                             sh.pw[0])

    def whole(bufs):   # (NS, B, Ws, D) by shard -> (B, n, D) at home
        g = mesh.all_gather(bufs)[0]
        return g.transpose(0, 1).reshape(b, n, -1).to(home)

    final = SimState(engine.unpack_worlds(whole([sh.bx for sh in shards])),
                     engine.unpack_worlds(whole([sh.bxt for sh in shards])),
                     t_final, states.generator)
    trace = _finish(_stack_rows(rows, SimTrace, dim=1),
                    None if tel is None else trows, dim=1)
    if knobs is not None:
        trace = trace._replace(defense=_stack_rows(drows, DefenseTrace,
                                                   dim=1))
    return final, trace
