"""``Simulator.worlds_executable``: the callable and arguments a
``run_worlds`` call dispatches, with the host side done.  ``fn(*args)``
from fresh states is bit for bit ``run_worlds`` on the same states, on the
plain, channel, defense and per-event flavors, with and without a
``Telemetry`` spec, and with ``mesh=`` on two local CPU shards, where
``fn`` is ``launch.mesh_replay.sharded_replay`` itself."""
import numpy as np
import pytest
import torch

from repro_torch.core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                              DelayProcess, Simulator, SplitGradFn,
                              Telemetry, World, params_from_graph,
                              ring_graph)
from repro_torch.launch import MeshReplay, make_replay_mesh
from repro_torch.launch.mesh_replay import sharded_replay

N, D, ROUNDS = 8, 12, 4
TARGET = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)


def _draw(generator, n):
    return torch.randn(n, D, generator=generator)


def _apply(x, noise, ids):
    g = (x - torch.from_numpy(TARGET)[ids].to(x.dtype)) \
        + (0.05 * noise).to(x.dtype)
    return 0.5 * (g.float() ** 2).sum(dim=1), g


def _sim(**kw):
    return Simulator(SplitGradFn(_draw, _apply),
                     params_from_graph(ring_graph(N), True), 0.05,
                     device="cpu", **kw)


def _states(sim):
    return [sim.init(torch.zeros(D), N, torch.Generator().manual_seed(7 + b))
            for b in range(2)]


def _worlds(flavor):
    ring = ring_graph(N)
    if flavor in ("plain", "per_event"):
        return [World(topology=ring), World(topology=ring)], None
    if flavor == "channel":
        return [World(topology=ring, channel=ChannelModel(
                    delay=DelayProcess(horizon=2, prob=0.7))),
                World(topology=ring, channel=ChannelModel(
                    adversary=ByzantineEdges(ring.edges[:2], "scale",
                                             scale=40.0, prob=0.6),
                    drop_prob=0.1))], None
    byz = World(topology=ring, channel=ChannelModel(
        adversary=ByzantineEdges(ring.edges[:3], "scale", scale=60.0,
                                 prob=0.5)))
    return [byz, byz], [AdaptiveDefense(), AdaptiveDefense()]


def _same(a, b) -> bool:
    """Bit for bit, through tuples, dicts, tensors, arrays and generators."""
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("telemetry", [None, Telemetry()])
@pytest.mark.parametrize("flavor", ["plain", "channel", "defense",
                                    "per_event"])
def test_executable_is_run_worlds(flavor, telemetry):
    worlds, defenses = _worlds(flavor)
    sim = _sim(robust_rule="trim")
    scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(worlds)]
    kw = dict(defenses=defenses, telemetry=telemetry,
              engine=flavor != "per_event")
    want = sim.run_worlds(_states(sim), scheds, **kw)
    fn, args = sim.worlds_executable(_states(sim), scheds, **kw)
    got = fn(*args)
    assert _same(got, want)
    assert (want[1].telemetry is None) == (telemetry is None)
    assert (want[1].defense is None) == (defenses is None)
    if telemetry is None:
        name = {"plain": "run_worlds_coalesced",
                "channel": "run_worlds_channel",
                "defense": "run_worlds_channel",
                "per_event": "_run_worlds_per_event"}[flavor]
        assert fn == getattr(sim, name)


@pytest.mark.parametrize("telemetry", [None, Telemetry()])
@pytest.mark.parametrize("flavor", ["plain", "defense"])
def test_executable_with_mesh_is_sharded_replay(flavor, telemetry):
    worlds, defenses = _worlds(flavor)
    sim = _sim(robust_rule="trim")
    scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(worlds)]

    def mesh():
        return MeshReplay(make_replay_mesh(2, devices=["cpu"] * 2))

    want = sim.run_worlds(_states(sim), scheds, defenses=defenses,
                          telemetry=telemetry, mesh=mesh())
    fn, args = sim.worlds_executable(_states(sim), scheds,
                                     defenses=defenses, telemetry=telemetry,
                                     mesh=mesh())
    if telemetry is None:
        assert fn is sharded_replay
    assert _same(fn(*args), want)
