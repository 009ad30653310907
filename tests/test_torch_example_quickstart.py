"""The quickstart twin (``repro_torch.examples.quickstart``) against the
JAX example's sections, each written here with ``repro.core`` as
``examples/quickstart.py`` writes it (the same worlds, arms, step size and
seeds), on the CPU at 16 workers, dim 64 and 30 rounds, with a numpy ``b``
and the gradient noise at 0 (``jax.random`` and ``torch.Generator`` draw
different values).

Tolerances: consensus traces, losses, mean parameter norms and the
distance to the optimum at rtol 1e-5 (atol 1e-6), the final x row by
row within 1e-5 of each row's largest magnitude: f32 arithmetic in
another order in XLA and PyTorch; rejection counts exactly; finite-or-not exactly, then the
finite values.  Then the twin's printed lines parse, at the example's own noise
A2CiD2's consensus is below the baseline's, ``main`` runs end to end on
``--device cpu``, and without a card and without ``--device cpu`` it
raises.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch.examples import quickstart as qs

N, DIM, ROUNDS = 16, 64, 30
B = np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
GAMMA = 0.05


def j_quad(target):
    t = jnp.asarray(target)

    def grad_fn(x, key, worker_id):
        bi = t[worker_id] if t.ndim == 2 else t
        return 0.5 * jnp.sum((x - bi) ** 2), x - bi
    return grad_fn


def j_sim(target, accelerated, **kw):
    graph = J.ring_graph(N)
    return J.Simulator(j_quad(target),
                       J.params_from_graph(graph, accelerated=accelerated),
                       gamma=GAMMA, backend="ref", **kw)


def j_start(sim):
    return sim.init(jnp.zeros(DIM), N, jax.random.PRNGKey(2))


def port(section):
    return section(torch.from_numpy(B), 0.0, ROUNDS, "cpu")


def same_trace(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], err_msg=what, **TOL)


def same_run(run, jstate, jtrace, what, mean_norm=True):
    """Loss and consensus traces, the mean parameter norm (``mean_norm``)
    and the final x: finite-or-not exactly, then each row within 1e-5 of
    that row's largest magnitude."""
    names = ("loss", "consensus") + (("mean_param_norm",) if mean_norm
                                     else ())
    for name in names:
        same_trace(getattr(run.trace, name), getattr(jtrace, name),
                   f"{what} {name}")
    got, want = run.state.x.numpy(), np.asarray(jstate.x)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin,
                                  err_msg=f"{what} x finite")
    # row by row: undefended rows reach ~5e12 beside rows far smaller, and
    # one bound for the whole array would pass any value in those
    scale = np.abs(np.where(fin, want, 0)).max(-1, keepdims=True)
    bound = TOL["rtol"] * np.broadcast_to(scale, want.shape)
    worst = np.max(np.abs(got - want)[fin] - bound[fin], initial=-1.0)
    assert worst <= 0, f"{what} x: a row parts by more than 1e-5 of its " \
                       f"largest magnitude ({worst:.3e} over)"


def test_calm_ring_matches_jax():
    got = port(qs.calm_ring)
    graph = J.ring_graph(N)
    assert got.lines[0] == (
        f"ring graph: chi1={graph.chi1():.1f} chi2={graph.chi2():.2f} "
        f"(A2CiD2 accelerates chi1 -> sqrt(chi1*chi2)="
        f"{(graph.chi1() * graph.chi2()) ** 0.5:.1f})")
    for name, accelerated in (("baseline", False), ("A2CiD2", True)):
        sim = j_sim(B, accelerated)
        state, trace = sim.run_world(j_start(sim), J.World(topology=graph),
                                     ROUNDS, seed=0)
        err = float(jnp.sum((J.worker_mean(state.x)
                             - jnp.mean(jnp.asarray(B), 0)) ** 2))
        same_run(got.runs[name], state, trace, name)
        np.testing.assert_allclose(got.runs[name].number, err, rtol=1e-5)


def test_hostile_world_matches_jax():
    got = port(qs.hostile)
    graph = J.ring_graph(N)
    stragglers = np.where(np.arange(N) % 2 == 0, 1.0, 0.25)
    active = np.ones(N, bool)
    active[:2] = False
    world = J.World(
        topology=graph, workers=J.WorkerModel(grad_rates=stragglers),
        faults=(J.PhaseSwitch(ROUNDS // 3, active=tuple(active)),
                J.PhaseSwitch(2 * (ROUNDS // 3),
                              topology=J.hypercube_graph(4))))
    sched = world.compile(ROUNDS, seed=0)
    tsched = qs.hostile_world(N, ROUNDS).compile(ROUNDS, seed=0)
    np.testing.assert_array_equal(tsched.partners, sched.partners)
    np.testing.assert_array_equal(tsched.grad_times, sched.grad_times)
    chis = ", ".join(f"{c1:.1f}" for c1, _ in
                     world.phase_plan(ROUNDS).phase_chis())
    for name, accelerated in (("baseline", False), ("A2CiD2", True)):
        sim = j_sim(B, accelerated)
        state, trace = sim.run_schedule(j_start(sim), sched)
        same_run(got.runs[name], state, trace, name)
        line = next(x for x in got.lines if x.startswith(name))
        assert line.endswith(f"(per-phase chi1: {chis})")


def test_lossy_ring_matches_jax():
    got = port(qs.lossy)
    graph = J.ring_graph(N)
    world = J.World(topology=graph, channel=J.ChannelModel(
        delay=J.DelayProcess(horizon=3, prob=0.5),
        adversary=J.ByzantineEdges((graph.edges[0], graph.edges[8]),
                                   mode="scale", scale=1e3, prob=0.5),
        drop_prob=0.02))
    for name, robust in (("A2CiD2 no defense", False),
                         ("A2CiD2 + trim", True)):
        sim = j_sim(B, True, robust_clip=5.0 if robust else None,
                    robust_rule="trim")
        state, trace = sim.run_world(j_start(sim), world, ROUNDS, seed=0)
        # undefended, the rows grow to ~5e12 while their mean stays ~140
        # times smaller: the squared norm of that mean cancels, and XLA's
        # and PyTorch's summation orders part by ~3e-5 there
        same_run(got.runs[name], state, trace, name, mean_norm=robust)
    assert bool(torch.isfinite(got.runs["A2CiD2 + trim"].trace.consensus)
                .all())


def test_self_healing_matches_jax():
    got = port(qs.self_healing)
    graph = J.ring_graph(N)
    flippy = J.ChannelModel(adversary=J.ByzantineEdges(
        (graph.edges[0], graph.edges[8]), mode="sign_flip", prob=1.0))
    shared = 0.2 * B[0]
    for name, defense in (("static trim", None),
                          ("adaptive defense", J.AdaptiveDefense())):
        sim = j_sim(shared, True, robust_clip=5.0, robust_rule="trim")
        state, trace = sim.run_world(
            j_start(sim), J.World(topology=graph, channel=flippy,
                                  defense=defense), ROUNDS, seed=0)
        run = got.runs[name]
        same_run(run, state, trace, name)
        rej = float(jnp.sum(trace.defense.rejections)) if trace.defense \
            else 0.0
        assert run.number == rej
        if trace.defense is not None:
            np.testing.assert_array_equal(
                run.trace.defense.rejections.numpy(),
                np.asarray(trace.defense.rejections))
            np.testing.assert_array_equal(
                run.trace.defense.quarantined.numpy(),
                np.asarray(trace.defense.quarantined))
    assert got.runs["adaptive defense"].number > 0
    # the static trim never fires at honest scale: its replay is bit for
    # bit the undefended one
    sim = qs.Simulator(qs.quadratic_grad(torch.from_numpy(0.2 * B[0]), 0.0),
                       qs.params_from_graph(qs.ring_graph(N), True), GAMMA,
                       device="cpu")
    state, _ = sim.run_world(qs._start(sim, N, DIM),
                             qs.sign_flip_world(qs.ring_graph(N), None),
                             ROUNDS, seed=0)
    assert torch.equal(state.x, got.runs["static trim"].state.x)


def test_sweep_rows_match_jax():
    got = port(qs.sweep)
    graph = J.ring_graph(N)
    grid = J.WorldSweep.over(J.World(topology=graph), seeds=(0, 1),
                             comms_per_grad=[0.5, 1.0, 2.0])
    sim = j_sim(B, True)
    _, traces = sim.run_worlds([j_start(sim) for _ in range(grid.size)],
                               grid.compile(ROUNDS))
    run = got.runs["sweep"]
    assert run.trace.consensus.shape == (6, ROUNDS)
    for i in range(grid.size):
        same_trace(run.trace.consensus[i], traces.consensus[i], f"world {i}")
        same_trace(run.trace.loss[i], traces.loss[i], f"world {i} loss")
    assert [x.split(":")[0] for x in got.lines[1:]] == [
        f"comms/grad={w.comms_per_grad:<4} seed={s}"
        for w, s in grid.points()]


LINE = {
    "calm": re.compile(r"^(baseline|A2CiD2  ): consensus distance "
                       r"\d+\.\d{3}  distance to optimum \d\.\d{2}e[+-]\d+$"),
    "hostile": re.compile(r"^(baseline|A2CiD2  ): consensus distance "
                          r"\d+\.\d{3}  \(per-phase chi1: [\d., ]+\)$"),
    "lossy": re.compile(r"^A2CiD2 (no defense|\+ trim   ): consensus "
                        r"distance (DIVERGED|\d+\.\d{3})$"),
    "self_healing": re.compile(r"^(static trim    |adaptive defense): "
                               r"consensus distance \d+\.\d{4}  \(rejected "
                               r"exchanges: \d+\)$"),
    "sweep": re.compile(r"^comms/grad=[\d.]+ +seed=\d: consensus distance "
                        r"\d+\.\d{3}$"),
}


def test_main_on_cpu_prints_the_examples_lines(capsys):
    out = qs.main(["--device", "cpu", "--rounds", "12"])
    printed = capsys.readouterr().out.split("\n")
    assert printed[0].startswith("ring graph: chi1=")
    lines = [x for x in printed if x]
    assert len(lines) == 1 + 2 + 1 + 2 + 1 + 2 + 1 + 2 + 1 + 6
    for name, section in out.items():
        body = section.lines[1:]
        assert all(LINE[name].match(x) for x in body), (name, body)
        assert all(x in printed for x in body)
    for run in out["calm"].runs.values():
        assert run.state.x.device.type == "cpu"


def test_acceleration_shows_at_the_examples_noise():
    got = qs.calm_ring(qs.draw_b(), qs.NOISE, qs.ROUNDS, "cpu")
    assert float(got.runs["A2CiD2"].trace.consensus[-1]) < \
        float(got.runs["baseline"].trace.consensus[-1])
    assert got.runs["A2CiD2"].number < 1e-2


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.main(["--rounds", "2"])
    with pytest.raises(ValueError, match="power of two"):
        qs.hostile(torch.zeros(6, 4), 0.0, 3, "cpu")
