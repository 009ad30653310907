"""Port parity: event schedules, coalesced schedules and event streams of
``repro_torch.core.events`` are exactly equal to the JAX package's, and the
graph constants chi1/chi2 are the same numbers."""
import jax  # noqa: F401  (JAX on the CPU, as the reference runs here)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import events as jev
from repro.core import graphs as jgr
from repro_torch.core import events as tev
from repro_torch.core import graphs as tgr

GRAPHS = [("ring", 16), ("torus", 16), ("hypercube", 16), ("complete", 8)]


def _assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f}[{k}]")
                assert x[k].dtype == y[k].dtype
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


SCHED = ("partners", "event_times", "event_mask", "grad_times", "grad_mask",
         "alive", "extras")
COAL = ("partners", "wtimes", "batch_active", "grad_times", "grad_mask",
        "alive", "extras")
STREAM = ("prologue", "partners", "dt_next", "is_grad", "grad_scale",
          "grad_pos", "t_final", "extras")


def _both(name, n, rounds, **kw):
    js = jev.make_schedule(jgr.build_graph(name, n), rounds, **kw)
    ts = tev.make_schedule(tgr.build_graph(name, n), rounds, **kw)
    return js, ts


@pytest.mark.parametrize("name,n", GRAPHS)
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("cpg", [0.5, 1.0, 2.0])
def test_schedule_coalesce_stream_equal(name, n, seed, cpg):
    js, ts = _both(name, n, 12, comms_per_grad=cpg, seed=seed)
    _assert_same(js, ts, SCHED)
    jc, tc = jev.coalesce_schedule(js), tev.coalesce_schedule(ts)
    _assert_same(jc, tc, COAL)
    assert jc.num_batches() == tc.num_batches()
    t0 = np.random.default_rng(seed).uniform(0, 0.3, n).astype(np.float32)
    _assert_same(jev.coalesced_stream(jc, t0), tev.coalesced_stream(tc, t0),
                 STREAM)


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_and_churn_schedules_equal(seed):
    rates = np.where(np.arange(16) % 2 == 0, 1.0, 0.25)
    active = np.ones(16, bool)
    active[:2] = False
    for kw in ({"grad_rates": rates}, {"active": active},
               {"grad_rates": rates, "jitter_grad_times": False,
                "t_offset": 3.0}):
        js, ts = _both("ring", 16, 10, seed=seed, **kw)
        _assert_same(js, ts, SCHED)
        jc, tc = jev.coalesce_schedule(js), tev.coalesce_schedule(ts)
        _assert_same(jc, tc, COAL)
        z = np.zeros(16, np.float32)
        _assert_same(jev.coalesced_stream(jc, z),
                     tev.coalesced_stream(tc, z), STREAM)


def test_per_edge_schedule_equal():
    g = jgr.ring_graph(8)
    rates = np.linspace(0.2, 1.0, g.num_edges)
    js = jev.make_schedule(g, 6, seed=2, edge_rates=rates)
    ts = tev.make_schedule(tgr.ring_graph(8), 6, seed=2, edge_rates=rates)
    _assert_same(js, ts, SCHED)


def test_concat_schedules_equal():
    g = jgr.ring_graph(8)
    parts_j = [jev.make_schedule(g, 4, comms_per_grad=c, seed=s,
                                 t_offset=4.0 * s)
               for s, c in enumerate((0.5, 2.0))]
    parts_t = [tev.make_schedule(tgr.ring_graph(8), 4, comms_per_grad=c,
                                 seed=s, t_offset=4.0 * s)
               for s, c in enumerate((0.5, 2.0))]
    _assert_same(jev.concat_schedules(parts_j),
                 tev.concat_schedules(parts_t), SCHED)


@pytest.mark.parametrize("name,n", GRAPHS + [("exponential", 16),
                                            ("star", 8)])
def test_chi_constants_equal(name, n):
    jg, tg = jgr.build_graph(name, n), tgr.build_graph(name, n)
    assert jg.edges == tg.edges and jg.rates == tg.rates
    assert jg.chi1() == tg.chi1()
    assert jg.chi2() == tg.chi2()
    # pin the ring's closed form too: chi1 = 1 / (rate * (2 - 2cos(2pi/n)))
    if name == "ring":
        lam2 = 0.5 * (2 - 2 * np.cos(2 * np.pi / n))
        np.testing.assert_allclose(tg.chi1(), 1 / lam2, rtol=1e-12)


@pytest.mark.parametrize("name,n", GRAPHS)
@pytest.mark.parametrize("cpg", [0.5, 2.0])
def test_comm_counters_and_empirical_laplacian_equal(name, n, cpg):
    js, ts = _both(name, n, 12, comms_per_grad=cpg, seed=2)
    jc, tc = js.comm_events_per_round(), ts.comm_events_per_round()
    assert tc.dtype == jc.dtype and tc.shape == (12,)
    np.testing.assert_array_equal(tc, jc)
    assert ts.num_comm_events() == js.num_comm_events() == int(jc.sum())
    for rounds in (None, 5):
        jl = jev.empirical_laplacian(js, rounds)
        tl = tev.empirical_laplacian(ts, rounds)
        assert tl.dtype == jl.dtype
        np.testing.assert_array_equal(tl, jl)
