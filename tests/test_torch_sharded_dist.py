"""The sharded replay with one ``torch.distributed`` rank per shard.

Two and four gloo ranks on the CPU, each a process started with the spawn
method, joined through a ``file://`` store (no network port) and given a
time limit.  Every rank replays the same worlds through
``make_rank_mesh("cpu")`` — the channel and the defense flavour at lag 0,
and the channel flavour at lag 1 — and writes what it got; the test then
holds each rank's result bit for bit against the port's single-device
replay (of ``shard_lag_schedule`` at lag 1), generators included, with the
traces (sums of per-rank partials, reassociated) at rtol 1e-6.  The
defense trace is bit for bit: its counts are sums of integers.
"""
import multiprocessing as mp

import numpy as np
import pytest
import torch

from repro_torch.core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                              DelayProcess, Simulator, SplitGradFn, World,
                              params_from_graph, ring_graph,
                              shard_lag_schedule)

N, D, ROUNDS = 16, 24, 6
JOIN_S = 240
TARGET = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)


def _draw(generator, n):
    return torch.randn(n, D, generator=generator)


def _apply(x, noise, ids):
    g = x - torch.from_numpy(TARGET)[ids] + 0.05 * noise
    return 0.5 * (g ** 2).sum(dim=1), g


def _sim():
    return Simulator(SplitGradFn(_draw, _apply),
                     params_from_graph(ring_graph(N), True), 0.05,
                     device="cpu")


def _cases():
    """(label, worlds, defenses, lag) of the replays every rank runs."""
    ring = ring_graph(N)
    chan = [World(topology=ring, channel=ChannelModel(
                delay=DelayProcess(horizon=2, prob=0.7))),
            World(topology=ring, channel=ChannelModel(
                adversary=ByzantineEdges(ring.edges[:2], "scale",
                                         scale=40.0, prob=0.6),
                drop_prob=0.1))]
    byz = World(topology=ring, channel=ChannelModel(
        adversary=ByzantineEdges(ring.edges[:3], "scale", scale=60.0,
                                 prob=0.5)))
    return [("channel", chan, None, 0),
            ("defense", [byz, byz], [AdaptiveDefense()] * 2, 0),
            ("lag1", chan, None, 1)]


def _states(sim, count):
    return [sim.init(torch.zeros(D), N,
                     torch.Generator().manual_seed(100 + b))
            for b in range(count)]


def _rank_main(rank, size, store, out):
    import torch.distributed as dist
    from repro_torch.launch import MeshReplay, make_rank_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)
    try:
        sim, got = _sim(), {}
        for label, worlds, defenses, lag in _cases():
            scheds = [w.compile(ROUNDS, seed=s)
                      for s, w in enumerate(worlds)]
            final, trace = sim.run_worlds(
                _states(sim, len(worlds)), scheds, defenses=defenses,
                mesh=MeshReplay(make_rank_mesh("cpu"), lag=lag))
            got[label] = (final.x, final.x_tilde,
                          [g.get_state() for g in final.generator],
                          trace.loss, trace.consensus,
                          None if trace.defense is None
                          else tuple(trace.defense))
        torch.save(got, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("size", [2, 4])
def test_gloo_ranks_pin_single_device(tmp_path, size):
    ctx = mp.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pt" for r in range(size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, str(tmp_path / "store"), str(o)))
             for r, o in enumerate(outs)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * size
    sim = _sim()
    for label, worlds, defenses, lag in _cases():
        scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(worlds)]
        if lag:
            scheds = [shard_lag_schedule(sc, size, lag) for sc in scheds]
        final, trace = sim.run_worlds(_states(sim, len(worlds)), scheds,
                                      defenses=defenses)
        for r, out in enumerate(outs):
            x, xt, gens, loss, cons, dtr = torch.load(out)[label]
            what = f"{label}, rank {r} of {size}"
            assert torch.equal(x, final.x), what
            assert torch.equal(xt, final.x_tilde), what
            assert all(torch.equal(a, b.get_state())
                       for a, b in zip(gens, final.generator)), what
            torch.testing.assert_close(loss, trace.loss, rtol=1e-6, atol=0)
            torch.testing.assert_close(cons, trace.consensus, rtol=1e-6,
                                       atol=0)
            if defenses is not None:
                assert all(torch.equal(a, b)
                           for a, b in zip(dtr, trace.defense)), what
