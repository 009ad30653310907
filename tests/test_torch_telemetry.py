"""Port parity for the replay's flight recorder (``core/telemetry.py`` and
the telemetry threading of ``core/simulator.py``): the spec, its JSON and
validation, the host-side schedule columns and the per-round runtime
columns of every serial and world-batched flavour (clean, channel under
trim / clip / coord, defense; engine and per-event; f32 and bf16) against
the JAX package's (``backend="ref"``), ``telemetry=None`` a bitwise no-op,
the World JSON and ``run_world`` carrying a spec, ``trace_summary``, the
shard split without a mesh, and a row wider than 2^24 bytes.

Tolerances: counts, bytes and every schedule column exactly equal; the
delta-norm moments rtol 1e-5 (the same f32 norms, summed in another order
by XLA and PyTorch); the replays' losses rtol 1e-5 at f32 and 2e-3 at
bf16.  Inputs: quadratic targets and starts from numpy
seeds; the gradients are noise-free.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaptiveDefense as JDefense
from repro.core import ByzantineEdges as JByz
from repro.core import ChannelModel as JChannel
from repro.core import DelayProcess as JDelay
from repro.core import Simulator as JSim
from repro.core import Telemetry as JTel
from repro.core import TelemetryTrace as JTrace
from repro.core import World as JWorld
from repro.core import WorldSweep as JSweep
from repro.core import complete_graph as j_complete
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro.core import telemetry as jtel
from repro.core import trace_summary as j_summary
from repro_torch.core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                              DelayProcess, Simulator, Telemetry,
                              TelemetryTrace, World, WorldSweep,
                              complete_graph, params_from_graph, ring_graph,
                              trace_summary)
from repro_torch.core import engine as engine_mod
from repro_torch.core import telemetry as ttel

N, D, ROUNDS, GAMMA, TAU = 8, 24, 7, 0.05, 1.0
TARGETS = np.random.default_rng(11).normal(size=(N, D)).astype(np.float32)
X0 = np.random.default_rng(12).normal(size=D).astype(np.float32)
MOMENT_RTOL = 1e-5
RUNTIME = ("applied", "rejected", "bytes_moved")
SCHEDULE = ("scheduled", "dropped", "stale_hist", "participation",
            "cross_reads", "bytes_intra", "bytes_cross")
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _channels(pkg):
    """name -> ChannelModel (or None) of one package."""
    if pkg == "jax":
        Chan, Delay, Byz, ring = JChannel, JDelay, JByz, j_ring(N)
    else:
        Chan, Delay, Byz, ring = ChannelModel, DelayProcess, ByzantineEdges, \
            ring_graph(N)
    attack = Byz((ring.edges[0], ring.edges[3]), "scale", scale=1e3,
                 prob=0.5)
    return {"clean": None,
            "stale": Chan(delay=Delay(horizon=2, prob=0.5)),
            "drop": Chan(drop_prob=0.25),
            "corrupt": Chan(adversary=attack),
            "hostile": Chan(delay=Delay(horizon=2, prob=0.5),
                            adversary=attack, drop_prob=0.1)}


def _scheds(name, seed=3, cpg=1.5):
    """The same compiled schedule from both packages."""
    jw = JWorld(topology=j_ring(N), channel=_channels("jax")[name],
                comms_per_grad=cpg)
    tw = World(topology=ring_graph(N), channel=_channels("torch")[name],
               comms_per_grad=cpg)
    return jw.compile(ROUNDS, seed=seed), tw.compile(ROUNDS, seed=seed)


def _j_sim(rule="trim", tau=TAU, dtype=jnp.float32, accelerated=True):
    b = jnp.asarray(TARGETS).astype(dtype)

    def grad_fn(x, key, wid):
        g = x - b[wid]
        return 0.5 * jnp.sum(g.astype(jnp.float32) ** 2), g

    return JSim(grad_fn, j_params(j_ring(N), accelerated), GAMMA,
                backend="ref", robust_clip=tau, robust_rule=rule)


def _t_sim(rule="trim", tau=TAU, dtype=torch.float32, accelerated=True):
    b = torch.from_numpy(TARGETS).to(dtype)

    def grad_fn(x, generator, ids):
        g = x - b[ids]
        return 0.5 * (g.float() ** 2).sum(dim=1), g

    return Simulator(grad_fn, params_from_graph(ring_graph(N), accelerated),
                     GAMMA, robust_clip=tau, robust_rule=rule, device="cpu")


def _j_state(sim, dtype=jnp.float32):
    return sim.init(jnp.asarray(X0).astype(dtype), N, jax.random.PRNGKey(0))


def _t_state(sim, dtype=torch.float32):
    return sim.init(torch.from_numpy(X0).to(dtype), N,
                    torch.Generator().manual_seed(0))


def _np(a):
    if torch.is_tensor(a):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a)


def _assert_columns(jt, tt):
    """A port TelemetryTrace against JAX's: counts, bytes and schedule
    columns exactly, moments at MOMENT_RTOL."""
    assert tt.row_bytes == jt.row_bytes
    for k in RUNTIME + SCHEDULE:
        a, b = getattr(jt, k), getattr(tt, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=k)
    for k in ("norm_sum", "norm_sq_sum"):
        a, b = getattr(jt, k), getattr(tt, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(_np(b), np.asarray(a),
                                       rtol=MOMENT_RTOL, atol=1e-6,
                                       err_msg=k)


def _assert_budget(tt):
    """applied + rejected + dropped == scheduled, every round."""
    total = _np(tt.applied) + _np(tt.rejected) + tt.dropped
    np.testing.assert_array_equal(total, tt.scheduled)


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("kw", [dict(staleness_buckets=(2, 1)),
                                dict(staleness_buckets=(0, 1)),
                                dict(staleness_buckets=(1, 1)),
                                dict(staleness_buckets=("a",)),
                                dict(shards=-1)])
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JTel(**kw)
    with pytest.raises(ValueError) as terr:
        Telemetry(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(), dict(staleness_buckets=(1, 3),
                                             norm_moments=False),
                                dict(participation=False, bytes_moved=False,
                                     shards=4),
                                dict(staleness_buckets=[2, 5.0])])
def test_spec_json_equals_jax(kw):
    t, j = Telemetry(**kw), JTel(**kw)
    assert t.to_json() == j.to_json()
    assert t.to_dict() == j.to_dict()
    assert Telemetry.from_json(j.to_json()) == t
    assert hash(Telemetry.from_dict(t.to_dict())) == hash(t)


# ------------------------------------------------------ schedule columns

@pytest.mark.parametrize("name", ["clean", "stale", "drop", "corrupt",
                                  "hostile"])
@pytest.mark.parametrize("shards", [0, 2, 3])
def test_schedule_columns_equal_jax(name, shards):
    js, ts = _scheds(name)
    np.testing.assert_array_equal(ts.partners, js.partners)
    spec = dict(shards=shards, staleness_buckets=(1, 2))
    jc = jtel.schedule_columns(JTel(**spec), js)
    tc = ttel.schedule_columns(Telemetry(**spec), ts)
    assert jc.keys() == tc.keys()
    for k in jc:
        assert (jc[k] is None) == (tc[k] is None), k
        if jc[k] is not None:
            assert tc[k].dtype == jc[k].dtype, k
            np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    for ns in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            ttel.cross_shard_reads(ts.partners, ts.event_mask, ns),
            jtel.cross_shard_reads(js.partners, js.event_mask, ns))


def test_batch_schedule_columns_equal_jax_on_a_sweep():
    kw = dict(comms_per_grad=(1.0, 2.0), seeds=(0, 1))
    jsw = JSweep.over(JWorld(topology=j_ring(N),
                             channel=_channels("jax")["hostile"]), **kw)
    tsw = WorldSweep.over(World(topology=ring_graph(N),
                                channel=_channels("torch")["hostile"]), **kw)
    spec = dict(shards=2)
    jc = jtel.batch_schedule_columns(JTel(**spec), jsw.compile(ROUNDS))
    tc = ttel.batch_schedule_columns(Telemetry(**spec), tsw.compile(ROUNDS))
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    assert tc["stale_hist"].shape == (4, ROUNDS, 6)


# ------------------------------------------------------- serial replays

FLAVOURS = {  # name -> (schedule, robust rule, tau, defense)
    "clean": ("clean", "trim", None, False),
    "trim": ("hostile", "trim", TAU, False),
    "clip": ("hostile", "clip", TAU, False),
    "coord": ("hostile", "coord", 0.1, False),
    "defense": ("hostile", "trim", TAU, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_replay_columns_match_jax(flavour, engine, dtype):
    name, rule, tau, defense = FLAVOURS[flavour]
    js, ts = _scheds(name)
    jsim = _j_sim(rule, tau, JDTYPE[dtype])
    tsim = _t_sim(rule, tau, dtype)
    jf, jt = jsim.run_schedule(_j_state(jsim, JDTYPE[dtype]), js,
                               engine=engine, telemetry=JTel(),
                               defense=JDefense() if defense else None)
    tf, tt = tsim.run_schedule(_t_state(tsim, dtype), ts, engine=engine,
                               telemetry=Telemetry(),
                               defense=AdaptiveDefense() if defense
                               else None)
    _assert_columns(jt.telemetry, tt.telemetry)
    _assert_budget(tt.telemetry)
    assert tt.telemetry.applied.shape == (ROUNDS,)
    # the loss is the test's diagnostic: at bf16 XLA squares the unrounded
    # difference x - b where the port squares the bf16 gradient
    np.testing.assert_allclose(tt.loss.numpy(), np.asarray(jt.loss),
                               rtol=1e-5 if dtype == torch.float32 else 2e-3)
    if flavour in ("trim", "defense"):
        assert float(tt.telemetry.rejected.sum()) > 0
    else:
        assert float(tt.telemetry.rejected.sum()) == 0


@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_telemetry_none_is_a_bitwise_noop(flavour, engine):
    name, rule, tau, defense = FLAVOURS[flavour]
    _, ts = _scheds(name)
    sim = _t_sim(rule, tau)
    runs = [sim.run_schedule(_t_state(sim), ts, engine=engine, telemetry=t,
                             defense=AdaptiveDefense() if defense else None)
            for t in (None, Telemetry())]
    (f0, t0), (f1, t1) = runs
    assert t0.telemetry is None and t1.telemetry is not None
    for a, b in ((f0.x, f1.x), (f0.x_tilde, f1.x_tilde),
                 (f0.t_last, f1.t_last), (t0.loss, t1.loss),
                 (t0.consensus, t1.consensus),
                 (t0.mean_param_norm, t1.mean_param_norm)):
        assert torch.equal(a, b)
    if defense:
        for a, b in zip(t0.defense, t1.defense):
            assert torch.equal(a, b)
    if flavour == "clean":
        # a spec forces the channel flavour: bitwise the clean replay
        sim0 = _t_sim(tau=None)
        c0, ct = sim0.run_schedule(_t_state(sim0), ts, engine=engine)
        assert torch.equal(c0.x, f1.x) and torch.equal(ct.loss, t1.loss)


def test_clean_telemetry_takes_the_channel_op_once_per_comm_step(
        monkeypatch):
    """What JAX pins as one trace is pinned here as calls: with a spec a
    clean schedule calls the channel op once per comm step and the clean
    op never, the gradient once per round, one delta-norm reduce per comm
    step; without one, the clean op once per comm step only."""
    from repro_torch.core import coalesce_schedule, coalesced_stream
    _, ts = _scheds("clean")
    steps = coalesced_stream(coalesce_schedule(ts), np.zeros(N, np.float32))
    comm = int((~steps.is_grad).sum())
    calls = {"channel": 0, "clean": 0, "norms": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(engine_mod, "channel_event_stacked",
                        counted("channel", engine_mod.channel_event_stacked))
    monkeypatch.setattr(engine_mod, "gossip_event_stacked",
                        counted("clean", engine_mod.gossip_event_stacked))
    monkeypatch.setattr(engine_mod.FlatGossipEngine, "delta_norms",
                        staticmethod(counted(
                            "norms", engine_mod.FlatGossipEngine.delta_norms)))
    sim = _t_sim(tau=None)
    sim.run_schedule(_t_state(sim), ts, telemetry=Telemetry())
    assert calls == {"channel": comm, "clean": 0, "norms": comm}
    calls.update(channel=0, norms=0)
    sim.run_schedule(_t_state(sim), ts)
    assert calls == {"channel": 0, "clean": comm, "norms": 0}


def test_engine_and_per_event_columns_agree():
    _, ts = _scheds("hostile")
    sim = _t_sim()
    out = [sim.run_schedule(_t_state(sim), ts, engine=e,
                            telemetry=Telemetry(), defense=AdaptiveDefense())
           for e in (True, False)]
    a, b = out[0][1].telemetry, out[1][1].telemetry
    assert torch.equal(a.applied, b.applied)
    assert torch.equal(a.rejected, b.rejected)
    torch.testing.assert_close(a.norm_sum, b.norm_sum, rtol=MOMENT_RTOL,
                               atol=1e-6)


def test_spec_choices_change_no_number():
    _, ts = _scheds("hostile")
    sim = _t_sim()
    _, a = sim.run_schedule(_t_state(sim), ts, telemetry=Telemetry())
    _, b = sim.run_schedule(_t_state(sim), ts, telemetry=Telemetry(
        staleness_buckets=(1, 3), norm_moments=False, participation=False,
        bytes_moved=False))
    assert torch.equal(a.loss, b.loss)
    assert torch.equal(a.telemetry.applied, b.telemetry.applied)
    assert b.telemetry.norm_sum is None and b.telemetry.bytes_moved is None
    assert b.telemetry.participation is None and b.telemetry.row_bytes == 0
    assert b.telemetry.stale_hist.shape == (ROUNDS, 4)


# -------------------------------------------------------- worlds replays

def _worlds(pkg):
    if pkg == "jax":
        W, ring, Defense = JWorld, j_ring(N), JDefense
    else:
        W, ring, Defense = World, ring_graph(N), AdaptiveDefense
    chan = _channels(pkg)["hostile"]
    clean = W(topology=ring)
    lossy = dataclasses.replace(clean, channel=chan, comms_per_grad=2.0)
    return [clean, lossy, lossy], [None, None, Defense()]


@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("defended", [False, True])
def test_worlds_columns_match_jax_and_serial(engine, defended):
    jw, jd = _worlds("jax")
    tw, td = _worlds("torch")
    if not defended:
        jd = td = None
    jsched = [w.compile(ROUNDS, seed=s) for s, w in enumerate(jw)]
    tsched = [w.compile(ROUNDS, seed=s) for s, w in enumerate(tw)]
    jsim, tsim = _j_sim(), _t_sim()
    jf, jt = jsim.run_worlds([_j_state(jsim) for _ in jw], jsched,
                             defenses=jd, engine=engine,
                             telemetry=JTel(shards=2))
    tf, tt = tsim.run_worlds([_t_state(tsim) for _ in tw], tsched,
                             defenses=td, engine=engine,
                             telemetry=Telemetry(shards=2))
    _assert_columns(jt.telemetry, tt.telemetry)
    _assert_budget(tt.telemetry)
    assert tt.telemetry.applied.shape == (3, ROUNDS)
    off_f, off_t = tsim.run_worlds([_t_state(tsim) for _ in tw], tsched,
                                   defenses=td, engine=engine)
    assert torch.equal(off_f.x, tf.x) and torch.equal(off_t.loss, tt.loss)
    for b in range(3):   # each world's columns are its serial replay's
        _, st = tsim.run_schedule(_t_state(tsim), tsched[b], engine=engine,
                                  telemetry=Telemetry(shards=2),
                                  defense=None if td is None else td[b])
        for k in ("applied", "rejected"):
            assert torch.equal(getattr(tt.telemetry, k)[b],
                               getattr(st.telemetry, k)), (b, k)
        torch.testing.assert_close(tt.telemetry.norm_sq_sum[b],
                                   st.telemetry.norm_sq_sum,
                                   rtol=MOMENT_RTOL, atol=1e-6)
        np.testing.assert_array_equal(tt.telemetry.stale_hist[b],
                                      st.telemetry.stale_hist)


def test_worlds_take_the_one_spec_the_worlds_declare():
    tw, _ = _worlds("torch")
    spec = Telemetry(staleness_buckets=(1,))
    tw = [dataclasses.replace(w, telemetry=spec) for w in tw]
    tsched = [w.compile(ROUNDS, seed=s) for s, w in enumerate(tw)]
    sim = _t_sim()
    _, tr = sim.run_worlds([_t_state(sim) for _ in tw], tsched, worlds=tw)
    assert tr.telemetry.stale_hist.shape == (3, ROUNDS, 3)
    tw[0] = dataclasses.replace(tw[0], telemetry=Telemetry())
    with pytest.raises(ValueError, match="distinct Telemetry"):
        sim.run_worlds([_t_state(sim) for _ in tw], tsched, worlds=tw)


# ------------------------------------------------- World JSON, run_world

def test_world_carries_the_spec_through_json_and_run_world():
    spec = dict(staleness_buckets=(1, 3), shards=2)
    jw = JWorld(topology=j_ring(N), channel=_channels("jax")["hostile"],
                telemetry=JTel(**spec))
    tw = World(topology=ring_graph(N), channel=_channels("torch")["hostile"],
               telemetry=Telemetry(**spec))
    assert tw.to_json() == jw.to_json()
    assert World.from_json(jw.to_json()) == tw
    with pytest.raises(ValueError, match="telemetry") as terr:
        World(ring_graph(N), telemetry={"shards": 2})
    with pytest.raises(ValueError, match="telemetry") as jerr:
        JWorld(j_ring(N), telemetry={"shards": 2})
    assert str(terr.value) == str(jerr.value)
    jsim, tsim = _j_sim(), _t_sim()
    jf, jt = jsim.run_world(_j_state(jsim), jw, ROUNDS, seed=2)
    tf, tt = tsim.run_world(_t_state(tsim), tw, ROUNDS, seed=2)
    _assert_columns(jt.telemetry, tt.telemetry)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=1e-5,
                               atol=1e-6)
    sf, st = tsim.run_schedule(_t_state(tsim), tw.compile(ROUNDS, seed=2),
                               telemetry=tw.telemetry)
    assert torch.equal(sf.x, tf.x) and torch.equal(st.loss, tt.loss)


# ------------------------------------------------- summary, split, bytes

def test_trace_summary_equals_jax_with_a_diverged_world():
    rng = np.random.default_rng(5)
    cols = {k: rng.integers(0, 9, (3, 4)).astype(np.float32)
            for k in ("applied", "rejected")}
    norm = rng.random((3, 4)).astype(np.float32)
    norm[1, 2] = np.inf
    norm[2, 0] = np.nan
    sched = {k: rng.integers(0, 9, (3, 4)) for k in
             ("scheduled", "dropped", "cross_reads")}
    hist = rng.integers(0, 5, (3, 4, 6))
    common = dict(scheduled=sched["scheduled"], dropped=sched["dropped"],
                  stale_hist=hist, participation=None, row_bytes=44_685_096,
                  cross_reads=sched["cross_reads"],
                  bytes_intra=sched["scheduled"] * 3.0,
                  bytes_cross=sched["cross_reads"] * 7.0)
    jt = JTrace(applied=jnp.asarray(cols["applied"]),
                rejected=jnp.asarray(cols["rejected"]),
                norm_sum=jnp.asarray(norm), norm_sq_sum=jnp.asarray(norm),
                bytes_moved=jnp.asarray(cols["applied"]) * 44_685_096.0,
                **common)
    tt = TelemetryTrace(applied=torch.from_numpy(cols["applied"]),
                        rejected=torch.from_numpy(cols["rejected"]),
                        norm_sum=torch.from_numpy(norm),
                        norm_sq_sum=torch.from_numpy(norm),
                        bytes_moved=torch.from_numpy(cols["applied"])
                        * 44_685_096.0, **common)
    js, ts = j_summary(jt), trace_summary(tt)
    assert ts == js
    assert 0 < ts["norm_finite_frac"] < 1


def test_shard_split_without_a_mesh_equals_jax():
    js, ts = _scheds("hostile", seed=1, cpg=3.0)
    jsim, tsim = _j_sim(), _t_sim()
    _, jt = jsim.run_schedule(_j_state(jsim), js, telemetry=JTel(shards=2))
    _, tt = tsim.run_schedule(_t_state(tsim), ts,
                              telemetry=Telemetry(shards=2))
    _assert_columns(jt.telemetry, tt.telemetry)
    tel = tt.telemetry
    assert tel.cross_reads.sum() > 0
    np.testing.assert_array_equal(
        (tel.bytes_intra + tel.bytes_cross) / tel.row_bytes,
        tel.scheduled - tel.dropped)
    assert trace_summary(tel) == j_summary(jt.telemetry) | {
        "admitted_norm_mean": trace_summary(tel)["admitted_norm_mean"]}


def test_row_wider_than_2_24_bytes_moves_jax_bytes():
    """A replica of 2^22 + 1 f32 (16,777,220 bytes a row): the bytes column
    is JAX's f32 product, exactly."""
    d = 2 ** 22 + 1
    jg, tg = j_complete(2), complete_graph(2)
    jsched = JWorld(topology=jg).compile(2, seed=0)
    tsched = World(topology=tg).compile(2, seed=0)

    def jgrad(x, key, wid):
        return 0.5 * jnp.sum(x ** 2), x

    def tgrad(x, generator, ids):
        return 0.5 * (x ** 2).sum(dim=1), x

    jsim = JSim(jgrad, j_params(jg, True), GAMMA, backend="ref")
    tsim = Simulator(tgrad, params_from_graph(tg, True), GAMMA,
                     device="cpu")
    _, jt = jsim.run_schedule(jsim.init(jnp.ones(d), 2,
                                        jax.random.PRNGKey(0)),
                              jsched, telemetry=JTel())
    _, tt = tsim.run_schedule(tsim.init(torch.ones(d), 2,
                                        torch.Generator()),
                              tsched, telemetry=Telemetry())
    assert tt.telemetry.row_bytes == 4 * d > 2 ** 24
    assert tt.telemetry.bytes_moved.dtype == torch.float32
    np.testing.assert_array_equal(tt.telemetry.bytes_moved.numpy(),
                                  np.asarray(jt.telemetry.bytes_moved))
    # finalize_trace on ResNet-18-CIFAR's row: f32 rounding as JAX's
    applied = np.array([30.0, 22.0, 31.0], np.float32)
    cols = {"scheduled": np.zeros(3, np.int64),
            "dropped": np.zeros(3, np.int64), "stale_hist": None,
            "participation": None, "cross_reads": None}
    rb = 44_685_096
    jf = jtel.finalize_trace(JTel(), (jnp.asarray(applied),) * 4, cols, rb)
    tf = ttel.finalize_trace(Telemetry(), (torch.from_numpy(applied),) * 4,
                             cols, rb)
    np.testing.assert_array_equal(tf.bytes_moved.numpy(),
                                  np.asarray(jf.bytes_moved))
    assert ttel.row_bytes_of(tree={"w": torch.zeros(2, 3, 5),
                                   "b": torch.zeros(2, dtype=torch.bfloat16)}
                             ) == 15 * 4 + 2
