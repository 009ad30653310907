"""Port parity for the simulator: on a noise-free quadratic on a ring
(n=16, d=64) the port's ``run_schedule`` follows the JAX package's
(``backend="ref"``) round by round, the port's engine follows the port's
per-event replay, and A2CiD2 reaches a lower consensus distance than the
baseline; ``run_world``, the AR-SGD baseline ``allreduce_sgd``,
``a2cid2.p2p_event`` and ``engine.mix_flat`` follow the JAX package's.

Tolerance: rtol 1e-5 (atol 1e-6) — both sides run the same f32 sequence of
operations, but reductions and ``exp`` may round differently;
``allreduce_sgd`` rtol 1e-6 at f32 and bit for bit at bf16, ``p2p_event``
bit for bit at bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Simulator as JSim
from repro.core import make_schedule as j_make_schedule
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro_torch.core import (AdaptiveDefense, FlatGossipEngine, FlatLayout,
                              Simulator, Telemetry, make_schedule,
                              params_from_graph, ring_graph)
from repro_torch.core import simulator as simulator_mod
from repro_torch.core.simulator import SimState

N, DIM, ROUNDS, GAMMA = 16, 64, 30, 0.05
B = np.random.default_rng(1).normal(size=(N, DIM)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
# the per-round metric fields of SimTrace (its ``defense`` tail is None on
# clean replays)
METRICS = ("loss", "consensus", "mean_param_norm")


def j_grad_fn(x, key, worker_id):
    b = jnp.asarray(B)[worker_id]
    return 0.5 * jnp.sum((x - b) ** 2), x - b


def t_grad_fn(x, generator, worker_ids):
    b = torch.from_numpy(B).to(x.device)[worker_ids]
    return 0.5 * ((x - b) ** 2).sum(dim=1), x - b


def _port(accelerated, sched, engine=True):
    sim = Simulator(t_grad_fn, params_from_graph(ring_graph(N), accelerated),
                    GAMMA, device="cpu")
    state = sim.init(torch.zeros(DIM), N, torch.Generator().manual_seed(0))
    return sim.run_schedule(state, sched, engine=engine)


def _jax(accelerated, sched):
    sim = JSim(j_grad_fn, j_params(j_ring(N), accelerated), GAMMA,
               backend="ref")
    state = sim.init(jnp.zeros(DIM), N, jax.random.PRNGKey(0))
    return sim.run_schedule(state, sched)


@pytest.mark.parametrize("accelerated", [False, True])
@pytest.mark.parametrize("cpg", [1.0, 2.0])
def test_port_matches_jax_run_schedule(accelerated, cpg):
    kw = dict(comms_per_grad=cpg, seed=3)
    jf, jt = _jax(accelerated, j_make_schedule(j_ring(N), ROUNDS, **kw))
    tf, tt = _port(accelerated, make_schedule(ring_graph(N), ROUNDS, **kw))
    assert tt.defense is None and jt.defense is None
    for name in METRICS:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **TOL)
    np.testing.assert_allclose(tf.x_tilde.numpy(), np.asarray(jf.x_tilde),
                               **TOL)
    np.testing.assert_array_equal(tf.t_last.numpy(), np.asarray(jf.t_last))


@pytest.mark.parametrize("accelerated", [False, True])
def test_engine_matches_per_event_run(accelerated):
    sched = make_schedule(ring_graph(N), ROUNDS, comms_per_grad=1.5, seed=4)
    ef, et = _port(accelerated, sched, engine=True)
    rf, rt = _port(accelerated, sched, engine=False)
    assert et.defense is None and rt.defense is None
    for name in METRICS:
        torch.testing.assert_close(getattr(et, name), getattr(rt, name),
                                   **TOL)
    torch.testing.assert_close(ef.x, rf.x, **TOL)
    torch.testing.assert_close(ef.x_tilde, rf.x_tilde, **TOL)
    assert torch.equal(ef.t_last, rf.t_last)


def test_acid_consensus_below_baseline():
    sched = make_schedule(ring_graph(N), 60, seed=0)
    _, base = _port(False, sched)
    _, acid = _port(True, sched)
    # the paper's claim on a ring: the accelerated dynamic keeps workers
    # closer together over the same events (averaged over the tail)
    assert acid.consensus[-20:].mean() < base.consensus[-20:].mean()


def _two_shards():
    from repro_torch.launch import MeshReplay, make_replay_mesh
    return MeshReplay(make_replay_mesh(2, devices=["cpu", "cpu"]))


def _pins_sharded(sim, state, sched, **kw):
    """``run_schedule(mesh=)`` on 2 CPU shards: |x| and x~ bit for bit the
    single-device replay (a signed zero may differ), the defense and
    telemetry counts equal.  Returns the sharded trace."""
    f0, t0 = sim.run_schedule(state, sched, **kw)
    f1, t1 = sim.run_schedule(state, sched, mesh=_two_shards(), **kw)
    assert torch.equal(f0.x.abs(), f1.x.abs())
    assert torch.equal(f0.x_tilde.abs(), f1.x_tilde.abs())
    torch.testing.assert_close(t1.loss, t0.loss, rtol=1e-6, atol=0)
    if t0.defense is not None:
        assert all(torch.equal(a, b) for a, b in zip(t0.defense, t1.defense))
    if t0.telemetry is not None:
        assert torch.equal(t0.telemetry.applied, t1.telemetry.applied)
    return t1


def test_unported_flavors_raise():
    from repro_torch.core import SplitGradFn
    sim = Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                    device="cpu")
    state = sim.init(torch.zeros(DIM), N, torch.Generator())
    sched = make_schedule(ring_graph(N), 2, seed=0)
    # the sharded replay is ported: a plain grad_fn cannot be split over
    # shards (it is refused there), its draw / apply split runs and pins
    with pytest.raises(ValueError, match="draw / apply"):
        sim.run_schedule(state, sched, mesh=_two_shards())
    split = SplitGradFn(lambda generator, n: (),
                        lambda x, batch, ids: t_grad_fn(x, None, ids))
    sim = dataclasses.replace(sim, grad_fn=split)
    _pins_sharded(sim, state, sched)
    # the channel and defense flavors and their telemetry run sharded too;
    # a telemetry spec that is not a Telemetry is refused as JAX's World
    # refuses one
    stale = dataclasses.replace(
        sched, extras={"stale": np.zeros_like(sched.partners)})
    trace = _pins_sharded(sim, state, stale, telemetry=Telemetry())
    assert trace.telemetry.cross_reads.shape == (2,)
    with pytest.raises(ValueError, match="telemetry"):
        sim.run_schedule(state, stale, telemetry=object())
    _, trace = sim.run_schedule(state, stale, telemetry=Telemetry())
    assert trace.telemetry.applied.shape == (2,)
    robust = dataclasses.replace(sim, robust_clip=1.0)
    trace = _pins_sharded(robust, state, sched, defense=AdaptiveDefense())
    assert trace.defense.tau.shape == (2,)
    with pytest.raises(ValueError):
        FlatGossipEngine(FlatLayout.from_pytree(state.x, stacked=True),
                         robust.params, robust_rule="median")
    with pytest.raises(ValueError, match="robust_rule"):
        Simulator(t_grad_fn, robust.params, GAMMA, robust_clip=1.0,
                  robust_rule="median", device="cpu")


def test_int_tree_refused_on_card(monkeypatch):
    """A state no flat buffer can hold takes the per-event replay on the
    CPU, but on the card run_schedule refuses it rather than skip the
    kernel.  The card is only named here: the refusal comes before any
    tensor is moved, so the test runs on a CPU-only machine."""
    sched = make_schedule(ring_graph(N), 2, seed=0)
    ints = {"w": torch.zeros(N, DIM, dtype=torch.int32)}

    def int_grad_fn(x, generator, worker_ids):
        return torch.zeros(N), {"w": torch.zeros_like(x["w"])}

    params = params_from_graph(ring_graph(N))
    cpu = Simulator(int_grad_fn, params, GAMMA, device="cpu")
    state = SimState(ints, dict(ints), torch.zeros(N), torch.Generator())
    cpu.run_schedule(state, sched)   # per-event path on the CPU
    monkeypatch.setattr(simulator_mod, "resolve_device", torch.device)
    card = Simulator(int_grad_fn, params, GAMMA, device="cuda")
    with pytest.raises(NotImplementedError, match="torch.int32"):
        card.run_schedule(state, sched)


def test_run_world_matches_jax():
    from repro.core import ChannelModel as JChannel
    from repro.core import DelayProcess as JDelay
    from repro.core import World as JWorld
    from repro_torch.core import ChannelModel, DelayProcess, World
    jw = JWorld(j_ring(N), channel=JChannel(delay=JDelay(2, 0.5),
                                            drop_prob=0.1))
    tw = World(ring_graph(N), channel=ChannelModel(delay=DelayProcess(
        2, 0.5), drop_prob=0.1))
    jsim = JSim(j_grad_fn, j_params(j_ring(N), True), GAMMA, backend="ref")
    tsim = Simulator(t_grad_fn, params_from_graph(ring_graph(N), True),
                     GAMMA, device="cpu")
    jf, jt = jsim.run_world(jsim.init(jnp.zeros(DIM), N,
                                      jax.random.PRNGKey(0)), jw, 6, seed=4)
    tf, tt = tsim.run_world(tsim.init(torch.zeros(DIM), N,
                                      torch.Generator()), tw, 6, seed=4)
    for name in METRICS:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)), **TOL)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **TOL)
    sf, st = tsim.run_schedule(tsim.init(torch.zeros(DIM), N,
                                         torch.Generator()),
                               tw.compile(6, seed=4))
    assert torch.equal(sf.x, tf.x) and torch.equal(st.loss, tt.loss)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allreduce_sgd_matches_jax(dtype):
    from repro.core import allreduce_sgd as j_allreduce_sgd
    from repro_torch.core import allreduce_sgd
    """Per-worker curvatures are powers of two, so each gradient c_w x is
    exact at bf16 however XLA fuses the JAX side's grad_fn into the mean
    (it may skip rounding an intermediate the port rounds)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(3)
    curv = (2.0 ** rng.integers(-2, 3, N)).astype(np.float32)
    x0 = rng.normal(size=DIM).astype(np.float32)
    jc, tc = jnp.asarray(curv), torch.from_numpy(curv)

    def jg(x, key, wid):
        return 0.5 * jc[wid] * jnp.sum(x.astype(jnp.float32) ** 2), \
            (jc[wid] * x).astype(x.dtype)

    def tg(x, generator, ids):
        return 0.5 * tc[ids] * (x.float() ** 2).sum(dim=1), \
            tc[ids, None].to(x.dtype) * x

    jx, jl = j_allreduce_sgd(jg, 0.3, jnp.asarray(x0).astype(jdt), N, 9,
                             jax.random.PRNGKey(0))
    tx, tl = allreduce_sgd(tg, 0.3, torch.from_numpy(x0).to(dtype), N, 9,
                           torch.Generator(), device="cpu")
    assert tx.shape == (DIM,) and tl.shape == (9,) and tx.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    else:
        np.testing.assert_array_equal(
            tx.view(torch.int16).numpy(),
            np.asarray(jx).view(np.int16))
    assert float(tl[-1]) < float(tl[0])


def test_p2p_event_and_mix_flat_match_jax_bitwise():
    from repro.core import a2cid2 as ja
    from repro.core import engine as je
    from repro_torch.core import engine as te
    from repro_torch.core import mix_flat, p2p_event
    rng = np.random.default_rng(9)
    xi, xti, xj = (rng.normal(size=(5, 33)).astype(np.float32)
                   for _ in range(3))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        params = params_from_graph(ring_graph(N), True)
        jparams = j_params(j_ring(N), True)
        t_in = [{"a": torch.from_numpy(a).to(dt),
                 "b": [torch.from_numpy(a[0]).to(dt)]}
                for a in (xi, xti, xj)]
        j_in = [{"a": jnp.asarray(a).astype(jdt),
                 "b": [jnp.asarray(a[0]).astype(jdt)]} for a in (xi, xti, xj)]
        tx, txt = p2p_event(*t_in, params)
        jx, jxt = ja.p2p_event(*j_in, jparams)
        for t, j in ((tx["a"], jx["a"]), (txt["b"][0], jxt["b"][0])):
            assert torch.equal(t.float(),
                               torch.from_numpy(np.array(j, np.float32)))
        dts = rng.random(5).astype(np.float32)
        mx, mxt = mix_flat(t_in[0]["a"], t_in[1]["a"], params.eta,
                           torch.from_numpy(dts))
        jmx, jmxt = je.mix_flat(j_in[0]["a"], j_in[1]["a"], jparams.eta,
                                jnp.asarray(dts))
        np.testing.assert_allclose(mx.float().numpy(),
                                   np.asarray(jmx, np.float32), rtol=1e-6,
                                   atol=1e-6 if dt == torch.float32 else 1e-2)
        assert te.mix_flat is mix_flat
