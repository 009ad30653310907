"""Port parity for the simulator: on a noise-free quadratic on a ring
(n=16, d=64) the port's ``run_schedule`` follows the JAX package's
(``backend="ref"``) round by round, the port's engine follows the port's
per-event replay, and A2CiD2 reaches a lower consensus distance than the
baseline.

Tolerance: rtol 1e-5 (atol 1e-6) — both sides run the same f32 sequence of
operations, but reductions and ``exp`` may round differently.
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
                              Simulator, make_schedule, params_from_graph,
                              ring_graph)
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


def test_unported_flavors_raise():
    sim = Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                    device="cpu")
    state = sim.init(torch.zeros(DIM), N, torch.Generator())
    sched = make_schedule(ring_graph(N), 2, seed=0)
    for kw in ({"telemetry": object()}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            sim.run_schedule(state, sched, **kw)
    # the channel and defense flavors are ported, but not their telemetry
    # or sharded forms: those are refused before any replay starts
    stale = dataclasses.replace(
        sched, extras={"stale": np.zeros_like(sched.partners)})
    with pytest.raises(NotImplementedError, match="telemetry"):
        sim.run_schedule(state, stale, telemetry=object())
    robust = Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                       robust_clip=1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        robust.run_schedule(state, sched, defense=AdaptiveDefense(),
                            mesh=object())
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
