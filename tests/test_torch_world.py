"""Port parity for the declarative World API and the many-worlds batching.

  * ``World.compile`` and ``WorldSweep.compile`` give exactly the JAX
    package's schedules (every array, every extra) over ring, torus and
    complete graphs, stragglers, churn, a phase switch, a topology
    schedule, bandwidth-derived link rates, a channel, a defense with comm
    control, a DADAO clock and a serving load;
  * JSON goes both ways: the port's ``to_json`` loads in the JAX package's
    ``from_json`` and back, with equal compiles;
  * ``stack_schedules`` and ``stack_streams`` are exactly equal on a
    ragged batch, and ``Algorithm.params_for`` gives the same scalars.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import a2cid2 as ja2
from repro.core import channel as jch
from repro.core import defense as jdef
from repro.core import events as jev
from repro.core import graphs as jgr
from repro.core import world as jw
from repro_torch.core import a2cid2 as ta2
from repro_torch.core import channel as tch
from repro_torch.core import events as tev
from repro_torch.core import graphs as tgr
from repro_torch.core import world as tw

SCHED_FIELDS = ("partners", "event_times", "event_mask", "grad_times",
                "grad_mask", "alive")


def _scenarios():
    """JAX Worlds covering every compile stage (built on the JAX side; the
    port's twins come from their JSON)."""
    ring = jgr.ring_graph(12)
    n = ring.n
    return {
        "ring": jw.World(ring, comms_per_grad=1.5),
        "torus": jw.World(jgr.torus_graph(4), comms_per_grad=1.0),
        "complete": jw.World(jgr.complete_graph(8), comms_per_grad=2.0),
        "stragglers": jw.World(ring, workers=jw.WorkerModel(
            grad_rates=[1.0, 0.25, 1.0, 0.5] * 3)),
        "churn": jw.World(ring, faults=(jw.ChurnProcess(
            0.15, 0.4, workers=(1, 4, 7, 9)),)),
        "phase_switch": jw.World(ring, faults=(
            jw.PhaseSwitch(4, topology=jgr.complete_graph(n)),
            jw.PhaseSwitch(7, active=[True] * (n - 2) + [False] * 2))),
        "topology_schedule": jw.World(jgr.TopologySchedule((
            jgr.TopologyPhase(ring, 4),
            jgr.TopologyPhase(jgr.complete_graph(n), 6,
                              active=tuple([True] * (n - 1) + [False]))))),
        "bandwidth": jw.World(ring, links=jw.LinkModel(
            bandwidth_bytes_per_s=tuple(float(v) for v in
                                        np.linspace(1e9, 4e9, ring.num_edges)),
            msg_bytes=4e6, grad_seconds=0.01)),
        "channel": jw.World(ring, comms_per_grad=1.5, channel=jch.ChannelModel(
            delay=jch.DelayProcess(horizon=2, prob=0.5),
            adversary=jch.ByzantineEdges(ring.edges[:2], "sign_flip"),
            drop_prob=0.1)),
        "defense_comm": jw.World(ring, channel=jch.ChannelModel(
            adversary=jch.ByzantineEdges(ring.edges[:3], "scale", scale=1e3,
                                         prob=0.5)),
            defense=jdef.AdaptiveDefense(comm_lo=0.5, comm_hi=2.0,
                                         comm_degrade=1.0)),
        "dadao": jw.World(ring, algorithm=ja2.Algorithm(
            "dadao", grad_rate=0.5, gossip_rate=2.0)),
        "serve": jw.World(ring, serve=jw.ServeLoad(rate=2.0,
                                                   arrive_frac=0.5)),
    }


def _assert_same_schedule(ts, js):
    for f in SCHED_FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(ts.extras_dict()) == sorted(js.extras_dict())
    for k, a in js.extras_dict().items():
        assert ts.extras[k].dtype == a.dtype, k
        np.testing.assert_array_equal(ts.extras[k], a, err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(_scenarios()))
def test_world_compile_matches_jax_exactly(name, seed):
    jworld = _scenarios()[name]
    tworld = tw.World.from_json(jworld.to_json())
    rounds = None if name == "topology_schedule" else 10
    js = jworld.compile(rounds, seed=seed)
    ts = tworld.compile(rounds, seed=seed)
    _assert_same_schedule(ts, js)
    assert [(s.rounds, s.start, s.seed_offset) for s in
            tworld.segments(rounds, seed)] == \
        [(s.rounds, s.start, s.seed_offset) for s in
         jworld.segments(rounds, seed)]
    if name == "bandwidth":
        np.testing.assert_array_equal(tworld.round_seconds(ts),
                                      jworld.round_seconds(js))
    if name == "serve":
        jt = jworld.serve.sample_trace(10, seed)
        tt = tworld.serve.sample_trace(10, seed)
        for f in ("arrival_round", "prompt_len", "gen_len"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))


@pytest.mark.parametrize("name", list(_scenarios()))
def test_world_json_both_ways(name):
    jworld = _scenarios()[name]
    tworld = tw.World.from_json(jworld.to_json())
    # the port writes the JAX package's JSON, and reads its own back
    assert tworld.to_json() == jworld.to_json()
    assert tw.World.from_json(tworld.to_json()) == tworld
    back = jw.World.from_json(tworld.to_json())
    rounds = None if name == "topology_schedule" else 6
    _assert_same_schedule(tworld.compile(rounds, seed=1),
                          back.compile(rounds, seed=1))


def test_sweep_compile_and_json_match_jax():
    jbase = _scenarios()["channel"]
    jsweep = jw.WorldSweep.over(
        jbase, seeds=(0, 2), comms_per_grad=(1.0, 2.5),
        algorithm=(ja2.Algorithm("adpsgd"), ja2.Algorithm("a2cid2")))
    tsweep = tw.WorldSweep.from_json(jsweep.to_json())
    assert tsweep.to_json() == jsweep.to_json()
    assert tsweep.size == jsweep.size == 8
    assert [(w.to_json(), s) for w, s in tsweep.points()] == \
        [(w.to_json(), s) for w, s in jsweep.points()]
    for ts, js in zip(tsweep.compile(8), jsweep.compile(8)):
        _assert_same_schedule(ts, js)
    with pytest.raises(ValueError, match="unknown World field"):
        tw.WorldSweep.over(tw.World(tgr.ring_graph(4)), colour=(1, 2))
    with pytest.raises(ValueError, match="share one worker count"):
        tw.WorldSweep((tw.World(tgr.ring_graph(4)),
                       tw.World(tgr.ring_graph(6))))


def test_make_topology_schedule_matches_jax():
    jts = jgr.TopologySchedule((jgr.TopologyPhase(jgr.ring_graph(8), 3),
                                jgr.TopologyPhase(jgr.complete_graph(8), 4)))
    tts = tgr.TopologySchedule.from_dict(jts.to_dict())
    _assert_same_schedule(
        tev.make_topology_schedule(tts, comms_per_grad=1.5, seed=2,
                                   grad_rates=[1.0, 0.5] * 4),
        jev.make_topology_schedule(jts, comms_per_grad=1.5, seed=2,
                                   grad_rates=[1.0, 0.5] * 4))


def _ragged_batch(mod_w, mod_g, mod_ch):
    ring = mod_g.ring_graph(8)
    chan = mod_ch.ChannelModel(delay=mod_ch.DelayProcess(horizon=3,
                                                         prob=0.6))
    worlds = [mod_w.World(ring, comms_per_grad=0.5),
              mod_w.World(ring, comms_per_grad=2.5, channel=chan),
              mod_w.World(ring, comms_per_grad=1.0,
                          workers=mod_w.WorkerModel(
                              grad_rates=[1.0, 0.5] * 4))]
    return [w.compile(7, seed=i) for i, w in enumerate(worlds)]


def test_stack_schedules_and_streams_match_jax():
    jsc = _ragged_batch(jw, jgr, jch)
    tsc = _ragged_batch(tw, tgr, tch)
    for a, b in zip(tsc, jsc):
        _assert_same_schedule(a, b)
    jb, tb = jev.stack_schedules(jsc), tev.stack_schedules(tsc)
    for f in ("partners", "event_times", "event_mask", "grad_times",
              "grad_scale", "alive"):
        assert getattr(tb, f).dtype == getattr(jb, f).dtype, f
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    assert sorted(tb.extras_dict()) == sorted(jb.extras_dict())
    for k, a in jb.extras_dict().items():
        np.testing.assert_array_equal(tb.extras[k], a, err_msg=k)
    t0 = np.random.default_rng(0).uniform(size=(3, 8)).astype(np.float32)
    jst = jev.stack_streams([jev.coalesce_schedule(s) for s in jsc], t0)
    tst = tev.stack_streams([tev.coalesce_schedule(s) for s in tsc], t0)
    for f in ("prologue", "partners", "dt_next", "is_grad", "grad_scale",
              "grad_pos", "t_final"):
        assert getattr(tst, f).dtype == getattr(jst, f).dtype, f
        np.testing.assert_array_equal(getattr(tst, f), getattr(jst, f), f)
    assert sorted(tst.extras_dict()) == sorted(jst.extras_dict())
    for k, a in jst.extras_dict().items():
        np.testing.assert_array_equal(tst.extras[k], a, err_msg=k)
    # the worlds really are ragged: some round pads identity groups
    counts = [tev.coalesce_schedule(s).batch_active.sum(axis=1)
              for s in tsc]
    assert not all(np.array_equal(counts[0], c) for c in counts[1:])
    with pytest.raises(ValueError, match="round_batches"):
        tev.coalesced_stream(tev.coalesce_schedule(tsc[1]), t0[1],
                             round_batches=np.zeros(7, np.int64))


@pytest.mark.parametrize("kind", ta2.ALGORITHM_KINDS)
@pytest.mark.parametrize("accelerated", [None, False, True])
def test_algorithm_params_match_jax(kind, accelerated):
    ta = ta2.Algorithm(kind, accelerated=accelerated)
    ja = ja2.Algorithm(kind, accelerated=accelerated)
    assert ta.to_dict() == ja.to_dict()
    assert ta2.Algorithm.from_json(ja.to_json()) == ta
    for tg, jg in ((tgr.ring_graph(16), jgr.ring_graph(16)),
                   (tgr.torus_graph(4), jgr.torus_graph(4)),
                   (tgr.complete_graph(8), jgr.complete_graph(8))):
        assert dataclasses.asdict(ta.params_for(tg)) == \
            dataclasses.asdict(ja.params_for(jg))
    with pytest.raises(ValueError, match="kind='dadao' axis"):
        ta2.Algorithm("a2cid2", grad_rate=0.5)
    with pytest.raises(ValueError, match="Algorithm.kind"):
        ta2.Algorithm("sgd")


def test_world_validation_names_the_field():
    ring = tgr.ring_graph(6)
    with pytest.raises(ValueError, match=r"workers\.grad_rates must have"):
        tw.World(ring, workers=tw.WorkerModel(grad_rates=[1.0] * 5))
    with pytest.raises(ValueError, match="strictly increasing"):
        tw.World(ring, faults=(tw.PhaseSwitch(4), tw.PhaseSwitch(2)))
    with pytest.raises(ValueError, match="msg_bytes"):
        tw.LinkModel(bandwidth_bytes_per_s=1e9)
    with pytest.raises(ValueError, match=r"compile\(rounds"):
        tw.World(ring).compile()
