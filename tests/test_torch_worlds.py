"""Port parity for the world-batched replay, ``Simulator.run_worlds``.

Four worlds per batch mix baseline (adpsgd) and A2CiD2 dynamics, ragged
comms_per_grad (identity padding), per-world step sizes and, on the channel
flavors, distinct delay horizons, per-world robust thresholds and defense
arms.  Each world of the batch must agree with

  * the JAX package's SERIAL ``run_schedule(backend="ref")`` of that world
    within rtol 1e-5 / atol 1e-6 (the same f32 operations, but reductions
    and ``exp`` may round differently between XLA and PyTorch), and
  * the port's own serial replay within rtol 1e-6 / atol 1e-7,

with the defense's rejection and quarantine counts exactly equal, on the
engine and on the per-event path.  The JAX package's own batched replay is
not the oracle: its bitwise pin against its serial replay is red on this
tree.  Gradients are noise-free quadratics, except in the test that checks
that each world draws from its own generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import a2cid2 as ja2
from repro.core import channel as jch
from repro.core import defense as jdef
from repro.core import graphs as jgr
from repro.core import world as jw
from repro.core import Simulator as JSim
from repro_torch.core import (AdaptiveDefense, Simulator, World, WorldSweep,
                              params_from_graph, ring_graph)

N, DIM, ROUNDS = 12, 16, 12
B = np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)
GAMMAS = [0.05, 0.03, 0.05, 0.04]
TOL_JAX = dict(rtol=1e-5, atol=1e-6)
TOL_PORT = dict(rtol=1e-6, atol=1e-7)
METRICS = ("loss", "consensus", "mean_param_norm")


def j_grad_fn(x, key, worker_id):
    b = jnp.asarray(B)[worker_id]
    return 0.5 * jnp.sum((x - b) ** 2), x - b


def t_grad_fn(x, generator, worker_ids):
    b = torch.from_numpy(B).to(x.device)[worker_ids]
    return 0.5 * ((x - b) ** 2).sum(dim=1), x - b


def _jworlds(flavor):
    """Four JAX worlds per flavor (the port's twins come from JSON)."""
    ring = jgr.ring_graph(N)
    algos = (ja2.Algorithm("adpsgd"), ja2.Algorithm("a2cid2"))
    if flavor == "plain":
        sweep = jw.WorldSweep.over(jw.World(ring), algorithm=algos,
                                   comms_per_grad=(1.0, 2.5))
        return [w for w, _ in sweep.points()]
    if flavor == "channel":
        chans = [jch.ChannelModel(delay=jch.DelayProcess(1, prob=0.7)),
                 jch.ChannelModel(delay=jch.DelayProcess(3, prob=0.6),
                                  adversary=jch.ByzantineEdges(
                                      ring.edges[:2], "sign_flip"),
                                  drop_prob=0.1),
                 None,
                 jch.ChannelModel(drop_prob=0.2)]
    else:
        picks = np.linspace(0, ring.num_edges, 2, endpoint=False).astype(int)
        attack = jch.ChannelModel(
            delay=jch.DelayProcess(2, prob=0.5),
            adversary=jch.ByzantineEdges(tuple(ring.edges[i] for i in picks),
                                         "scale", scale=1e3, prob=0.5))
        chans = [attack] * 4
    return [jw.World(ring, channel=c, algorithm=algos[i % 2],
                     comms_per_grad=(1.0, 2.0, 1.5, 1.0)[i])
            for i, c in enumerate(chans)]


# per-world knobs of the channel and defense batches
KNOBS = {
    "plain": dict(robust_clips=None, defenses=None, clip=None),
    "channel": dict(robust_clips=[None, 0.5, 2.0, None], defenses=None,
                    clip=None),
    "defense": dict(robust_clips=None, clip=5.0,
                    defenses=[None, AdaptiveDefense(), None,
                              AdaptiveDefense()]),
}


def _setup(flavor):
    jworlds = _jworlds(flavor)
    tworlds = [World.from_json(w.to_json()) for w in jworlds]
    jsched = [w.compile(ROUNDS, seed=i) for i, w in enumerate(jworlds)]
    tsched = [w.compile(ROUNDS, seed=i) for i, w in enumerate(tworlds)]
    return jworlds, tworlds, jsched, tsched


def _port_sim(clip=None):
    return Simulator(t_grad_fn, params_from_graph(ring_graph(N)), 0.05,
                     robust_clip=clip, device="cpu")


def _port_states(sim, n_worlds):
    return [sim.init(torch.zeros(DIM), N,
                     torch.Generator().manual_seed(10 + b))
            for b in range(n_worlds)]


def _taus(knobs, b):
    clips = knobs["robust_clips"]
    return knobs["clip"] if clips is None or clips[b] is None else clips[b]


def _defense(knobs, b, mod=None):
    d = None if knobs["defenses"] is None else knobs["defenses"][b]
    if d is None or mod is None:
        return d
    return mod.AdaptiveDefense(**dataclasses.asdict(d))


@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("flavor", ["plain", "channel", "defense"])
def test_run_worlds_matches_serial_replays(flavor, engine):
    knobs = KNOBS[flavor]
    jworlds, tworlds, jsched, tsched = _setup(flavor)
    sim = _port_sim(knobs["clip"])
    final, trace = sim.run_worlds(
        _port_states(sim, 4), tsched, gammas=GAMMAS, worlds=tworlds,
        robust_clips=knobs["robust_clips"], defenses=knobs["defenses"],
        engine=engine)
    assert trace.loss.shape == (4, ROUNDS)
    assert (trace.defense is not None) == (flavor == "defense")
    for b in range(4):
        params = tworlds[b].algorithm_params()
        tau = _taus(knobs, b)
        # the port's own serial replay of world b
        serial = dataclasses.replace(sim, params=params, gamma=GAMMAS[b],
                                     robust_clip=tau)
        sf, st = serial.run_schedule(_port_states(sim, 4)[b], tsched[b],
                                     engine=engine,
                                     defense=_defense(knobs, b))
        # the JAX package's serial replay of world b
        jsim = JSim(j_grad_fn, jworlds[b].algorithm_params(), GAMMAS[b],
                    backend="ref", robust_clip=tau)
        jf, jt = jsim.run_schedule(
            jsim.init(jnp.zeros(DIM), N, jax.random.PRNGKey(0)), jsched[b],
            engine=engine, defense=_defense(knobs, b, jdef))
        for name in METRICS:
            got = getattr(trace, name)[b]
            torch.testing.assert_close(got, getattr(st, name), **TOL_PORT)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(jt, name)),
                                       err_msg=name, **TOL_JAX)
        for got, s, j in ((final.x[b], sf.x, jf.x),
                          (final.x_tilde[b], sf.x_tilde, jf.x_tilde)):
            torch.testing.assert_close(got, s, **TOL_PORT)
            np.testing.assert_allclose(got.numpy(), np.asarray(j),
                                       **TOL_JAX)
        np.testing.assert_array_equal(final.t_last[b].numpy(),
                                      np.asarray(jf.t_last))
        if flavor == "defense" and knobs["defenses"][b] is not None:
            for k in ("rejections", "quarantined"):
                np.testing.assert_array_equal(
                    getattr(trace.defense, k)[b].numpy(),
                    getattr(st.defense, k).numpy(), err_msg=k)
                np.testing.assert_array_equal(
                    getattr(trace.defense, k)[b].numpy(),
                    np.asarray(getattr(jt.defense, k)), err_msg=k)
            np.testing.assert_allclose(trace.defense.tau[b].numpy(),
                                       np.asarray(jt.defense.tau), **TOL_JAX)
    if flavor == "defense":
        # the adaptive arms acted, the neutral arms never quarantine
        assert float(trace.defense.rejections[1::2].sum()) > 0
        assert float(trace.defense.quarantined[0::2].sum()) == 0


def test_each_world_draws_from_its_own_generator():
    """A noisy gradient: row b of the batch equals world b's serial replay
    from the same generator seed, so each world keeps its own stream."""
    def noisy(x, generator, ids):
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
        b = torch.from_numpy(B)[ids]
        return 0.5 * ((x - b) ** 2).sum(dim=1), x - b + 0.1 * noise

    sim = Simulator(noisy, params_from_graph(ring_graph(N)), 0.05,
                    device="cpu")
    sweep = WorldSweep.over(World(ring_graph(N)), comms_per_grad=(1.0, 2.0),
                            seeds=(0, 1))
    scheds = sweep.compile(6)
    final, trace = sim.run_worlds(_port_states(sim, 4), scheds,
                                  worlds=[w for w, _ in sweep.points()])
    for b, sched in enumerate(scheds):
        sf, st = sim.run_schedule(_port_states(sim, 4)[b], sched)
        torch.testing.assert_close(final.x[b], sf.x, **TOL_PORT)
        torch.testing.assert_close(trace.consensus[b], st.consensus,
                                   **TOL_PORT)
    # worlds with one schedule and different seeds drew different noise
    assert not torch.equal(final.x[0], final.x[1])


def test_batched_state_in_and_validation():
    _, tworlds, _, tsched = _setup("plain")
    sim = _port_sim()
    states = sim.batch_states(_port_states(sim, 4))
    assert states.t_last.shape == (4, N) and len(states.generator) == 4
    f1, t1 = sim.run_worlds(states, tsched, worlds=tworlds)
    f2, t2 = sim.run_worlds(_port_states(sim, 4), tsched, worlds=tworlds)
    assert torch.equal(f1.x, f2.x) and torch.equal(t1.loss, t2.loss)
    with pytest.raises(ValueError, match="batched for 4 worlds"):
        sim.run_worlds(states, tsched[:3])
    with pytest.raises(ValueError, match="gammas must have one entry"):
        sim.run_worlds(states, tsched, gammas=[0.1])
    with pytest.raises(ValueError, match="robust_rule='trim'"):
        dataclasses.replace(sim, robust_clip=1.0, robust_rule="clip"
                            ).run_worlds(states, tsched,
                                         defenses=[AdaptiveDefense()] * 4)
