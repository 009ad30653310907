"""Port parity for the sharded worlds replay (``run_worlds(mesh=)``).

The contracts under test:

  * the host shard plan — ``events.shard_partition`` (all ten
    ``ShardPlan`` fields), ``shard_lag_stale``, ``world.shard_lag_schedule``,
    ``world.shard_cross_reads`` and the whole ``worlds_sharded_arrays``
    tuple — is EXACTLY the JAX package's, on random partner involutions
    and on compiled delay / drop / Byzantine schedules;
  * the device primitives — ``flatbuf.ring_pool_exchange``'s hop order
    (``jax.vmap`` with an axis name standing in for JAX's mesh axis),
    ``FlatGossipEngine.publish_rows`` and ``pool_partner_values`` — are
    exactly JAX's on the same numpy inputs;
  * pinning (lag 0) — on a local mesh of NS CPU shards (NS 1 to 8) the
    final x, x~ and generators are bit for bit the port's single-device
    ``run_worlds`` on topology, channel (delay + Byzantine + drop) and
    defense worlds, f32 and bf16, with a noisy quadratic drawn through
    ``SplitGradFn``; the defense trace is bit for bit; loss and consensus
    (sums of per-shard partials) within rtol 1e-6 at f32 and within
    bf16's resolution at bf16;
  * pinning (lag > 0) — bit for bit the single-device replay of
    ``shard_lag_schedule(sched, NS, L)``;
  * against the JAX package's SINGLE-device ``run_worlds`` (its sharded
    replay's own single-shard pin is red on this tree) on a noise-free
    gradient: f32 within rtol 1e-6, bf16 bit for bit;
  * ``run_schedule(mesh=)`` lifted to one world and squeezed; the ragged
    fallback; the refusals; the telemetry intra / cross byte split;
    ``MeshReplay`` and ``make_replay_mesh``; a reduced ResNet within 1e-5
    of the largest |x|.

The rank mesh (one ``torch.distributed`` process per shard) is held in
``test_torch_sharded_dist.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Simulator as JSim
from repro.core import params_from_graph as jpg
from repro.core import channel as jch
from repro.core import events as jev
from repro.core import graphs as jgr
from repro.core import telemetry as jtel
from repro.core import world as jw
from repro.core.engine import FlatGossipEngine as JEngine
from repro.core.flatbuf import ring_pool_exchange as j_pool_exchange
from repro_torch.core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                              DelayProcess, FlatGossipEngine, Simulator,
                              SplitGradFn, Telemetry, World,
                              params_from_graph, ring_graph)
from repro_torch.core import events as tev
from repro_torch.core import telemetry as ttel
from repro_torch.core import world as tw
from repro_torch.core.flatbuf import ring_pool_exchange
from repro_torch.launch import (LocalMesh, MeshReplay, make_rank_mesh,
                                make_replay_mesh)

N, D, ROUNDS = 16, 24, 6
TARGET = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
SHARDS = [1, 2, 4, 8]
DTYPES = [torch.float32, torch.bfloat16]
# traces cross the shards as sums of f32 partials, rounded to the buffer
# dtype: one f32 reassociation at f32, a bf16 rounding or two at bf16
TRACE_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -6}
PLAN_FIELDS = ("n_shards", "shard_size", "pool_width", "local_partner",
               "is_cross", "hop", "pool_pos", "pub_row", "pub_slot",
               "cross_reads")


def _draw(generator, n):
    return torch.randn(n, D, generator=generator)


def _apply(x, noise, ids):
    """Row-local noisy quadratic: each worker pulls to its own target."""
    g = (x - torch.from_numpy(TARGET)[ids].to(x.dtype)) \
        + (0.05 * noise).to(x.dtype)
    return 0.5 * (g.float() ** 2).sum(dim=1), g


NOISY = SplitGradFn(_draw, _apply)


def _quiet_apply(x, batch, ids):
    g = x - torch.from_numpy(TARGET)[ids].to(x.dtype)
    return 0.5 * (g.float() ** 2).sum(dim=1), g


QUIET = SplitGradFn(lambda generator, n: (), _quiet_apply)


def _sim(grad_fn=NOISY, n=N, **kw):
    return Simulator(grad_fn, params_from_graph(ring_graph(n), True), 0.05,
                     device="cpu", **kw)


def _states(sim, count, dtype=torch.float32, n=N):
    return [sim.init(torch.zeros(D, dtype=dtype), n,
                     torch.Generator().manual_seed(100 + b))
            for b in range(count)]


def _mesh(ns, lag=0):
    return MeshReplay(make_replay_mesh(ns, devices=["cpu"] * ns), lag=lag)


def _worlds(flavor):
    ring = ring_graph(N)
    if flavor == "topology":
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


def _assert_pinned(f0, t0, f1, t1, rtol=1e-6):
    """The sharded replay ``(f1, t1)`` against the single-device one."""
    assert torch.equal(f0.x, f1.x)
    assert torch.equal(f0.x_tilde, f1.x_tilde)
    assert torch.equal(f0.t_last, f1.t_last)
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(f0.generator, f1.generator))
    for k in ("loss", "consensus", "mean_param_norm"):
        torch.testing.assert_close(getattr(t1, k), getattr(t0, k),
                                   rtol=rtol, atol=0)
    if t0.defense is not None:
        assert all(torch.equal(a, b) for a, b in zip(t0.defense, t1.defense))


# ------------------------------------------------------- host shard plan

def _involutions(rng, S, B, n):
    partners = np.tile(np.arange(n, dtype=np.int32), (S, B, 1))
    for s in range(S):
        for b in range(B):
            perm = rng.permutation(n)
            for k in range(0, n - rng.integers(0, 4), 2):
                i, j = perm[k], perm[k + 1]
                partners[s, b, i], partners[s, b, j] = j, i
    return partners


@pytest.mark.parametrize("ns,h,seed", [(2, 0, 0), (4, 3, 1), (8, 2, 2),
                                       (16, 1, 3), (1, 2, 4)])
def test_shard_partition_exactly_jax(ns, h, seed):
    """All ten ShardPlan fields exactly JAX's on random involutions (idle
    rows included), and every cross read lands on the row and slot its
    reader asked for."""
    rng = np.random.default_rng(seed)
    S, B, n = 5, 3, 16
    partners = _involutions(rng, S, B, n)
    src_slot = rng.integers(0, h + 1, (S, B, n)).astype(np.int32)
    jp = jev.shard_partition(partners, src_slot, ns, h)
    tp = tev.shard_partition(partners, src_slot, ns, h)
    for f in PLAN_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
    ws = n // ns
    s, b, i = np.nonzero(tp.is_cross)
    p = partners[s, b, i]
    np.testing.assert_array_equal(
        tp.pub_row[s, p // ws, b, tp.pool_pos[s, b, i]], p % ws)
    np.testing.assert_array_equal(
        tp.pub_slot[s, p // ws, b, tp.pool_pos[s, b, i]], src_slot[s, b, i])
    np.testing.assert_array_equal(tp.hop[s, b, i], (i // ws - p // ws) % ns)
    with pytest.raises(ValueError, match="not divisible"):
        tev.shard_partition(partners, src_slot, 3, h)


@pytest.mark.parametrize("ns,lag", [(2, 1), (4, 2), (8, 3)])
def test_shard_lag_stale_exactly_jax(ns, lag):
    rng = np.random.default_rng(ns)
    S, B, n = 9, 2, 16
    partners = _involutions(rng, S, B, n)
    stale = rng.integers(0, 3, (S, B, n)).astype(np.int32)
    step_round = np.sort(rng.integers(0, 5, S))
    want = jev.shard_lag_stale(partners, stale, step_round, ns, lag)
    got = tev.shard_lag_stale(partners, stale, step_round, ns, lag)
    np.testing.assert_array_equal(want, got)
    assert want.dtype == got.dtype


def test_shard_lag_stale_floors_cross_only():
    S, B, n, ns = 4, 1, 8, 2
    partners = np.tile(np.arange(n, dtype=np.int32), (S, B, 1))
    partners[:, 0, 0], partners[:, 0, 4] = 4, 0      # cross pair
    partners[:, 0, 1], partners[:, 0, 2] = 2, 1      # intra pair
    stale = np.zeros((S, B, n), np.int32)
    stale[:, 0, 1] = 2
    out = tev.shard_lag_stale(partners, stale, np.arange(4), ns, lag=2)
    np.testing.assert_array_equal(out[:, 0, 0], [0, 1, 2, 2])  # floored
    np.testing.assert_array_equal(out[:, 0, 1], [2, 2, 2, 2])  # untouched
    np.testing.assert_array_equal(out[:, 0, 3], [0, 0, 0, 0])  # idle


def jax_params():
    return jpg(jgr.ring_graph(N), True)


def _jax_schedules():
    """Compiled JAX schedules with delay, drop and Byzantine extras, and
    the port's twins of the same worlds (by JSON)."""
    ring = jgr.ring_graph(N)
    jworlds = [
        jw.World(ring),
        jw.World(ring, channel=jch.ChannelModel(
            delay=jch.DelayProcess(3, prob=0.5), drop_prob=0.2)),
        jw.World(ring, channel=jch.ChannelModel(
            adversary=jch.ByzantineEdges(ring.edges[:3], "scale",
                                         scale=60.0, prob=0.5),
            delay=jch.DelayProcess(2, prob=0.7))),
    ]
    scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(jworlds)]
    tworlds = [World.from_json(w.to_json()) for w in jworlds]
    return scheds, [w.compile(ROUNDS, seed=s) for s, w in enumerate(tworlds)]


@pytest.mark.parametrize("ns,lag", [(1, 0), (2, 0), (4, 1), (8, 2),
                                    (3, 1)])
def test_schedule_shard_halves_exactly_jax(ns, lag):
    """shard_lag_schedule's extras and shard_cross_reads equal JAX's on
    compiled schedules (a ragged split raises JAX's error, or counts 0)."""
    jscheds, tscheds = _jax_schedules()
    for js, ts in zip(jscheds, tscheds):
        want, got = jw.shard_cross_reads(js, ns), tw.shard_cross_reads(ts,
                                                                       ns)
        np.testing.assert_array_equal(want, got)
        assert got.dtype == np.int64 and got.shape == (ROUNDS,)
        np.testing.assert_array_equal(
            got, ttel.cross_shard_reads(ts.partners, ts.event_mask, ns))
        if N % ns:
            with pytest.raises(ValueError, match="not divisible") as terr:
                tw.shard_lag_schedule(ts, ns, lag)
            with pytest.raises(ValueError) as jerr:
                jw.shard_lag_schedule(js, ns, lag)
            assert str(terr.value) == str(jerr.value)
            continue
        jl, tl = jw.shard_lag_schedule(js, ns, lag), \
            tw.shard_lag_schedule(ts, ns, lag)
        assert (tl is ts) == (jl is js)
        je, te = jl.extras_dict(), tl.extras_dict()
        assert sorted(je) == sorted(te)
        for k in je:
            np.testing.assert_array_equal(je[k], te[k], err_msg=k)


@pytest.mark.parametrize("ns,lag", [(2, 0), (4, 0), (4, 1), (8, 2)])
def test_worlds_sharded_arrays_exactly_jax(ns, lag):
    """The whole sharded stream tuple (the channel arrays, lagged, and the
    shard plan) and the ring depth equal JAX's ``worlds_sharded_arrays``."""
    jscheds, tscheds = _jax_schedules()
    spec = types.SimpleNamespace(n_shards=ns, lag=lag)
    jsim = JSim(lambda x, k, w: (0.0, x), jax_params(), 0.05)
    jstates = jsim.batch_states([jsim.init(jnp.zeros(D), N,
                                           jax.random.PRNGKey(0))
                                 for _ in jscheds])
    want, jh = jsim.worlds_sharded_arrays(jstates, jscheds, spec)
    sim = _sim()
    got, th = sim.worlds_sharded_arrays(
        sim.batch_states(_states(sim, len(tscheds))), tscheds, spec)
    assert jh == th
    assert len(want) == len(got) == 16
    for i, (a, b) in enumerate(zip(want, got)):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(i))


# ------------------------------------------------------ device primitives

@pytest.mark.parametrize("ns", SHARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_pool_exchange_hop_order(ns, dtype):
    """pool[h] on shard u is the block shard (u - h) mod NS published,
    exactly JAX's pool under a vmapped axis."""
    rng = np.random.default_rng(ns)
    vals = rng.normal(size=(ns, 2, 3, 8)).astype(np.float32)
    want = jax.vmap(lambda v: j_pool_exchange(v, "w", ns), axis_name="w")(
        jnp.asarray(vals, dtype))
    tvals = torch.from_numpy(vals).to(getattr(torch, dtype))
    got = ring_pool_exchange(list(tvals), make_replay_mesh(
        ns, devices=["cpu"] * ns))
    assert len(got) == ns
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  torch.stack(got).float().numpy())
    for u in range(ns):
        for h in range(ns):
            assert torch.equal(got[u][h], tvals[(u - h) % ns])


@pytest.mark.parametrize("horizon", [0, 3])
def test_publish_and_pool_reads_exactly_jax(horizon):
    """publish_rows resolves the published rows at their slots (fresh at
    the sentinel) and pool_partner_values merges the pool's cross reads,
    both exactly JAX's."""
    rng = np.random.default_rng(horizon)
    B, ws, dd, nb, ns = 3, 4, 8, 2, 4
    bx = rng.normal(size=(B, ws, dd)).astype(np.float32)
    ring = rng.normal(size=(B, horizon, ws, dd)).astype(np.float32) \
        if horizon else None
    rows = rng.integers(0, ws, (B, nb)).astype(np.int32)
    slots = rng.integers(0, horizon + 1, (B, nb)).astype(np.int32)
    je = JEngine.for_pytree(jnp.zeros((B, ws, dd)), jax_params(),
                            stacked=True, worlds=True)
    want = je.publish_rows(None if ring is None else jnp.asarray(ring),
                           jnp.asarray(bx), jnp.asarray(rows),
                           jnp.asarray(slots))
    got = FlatGossipEngine.publish_rows(
        None if ring is None else torch.from_numpy(ring),
        torch.from_numpy(bx), torch.from_numpy(rows),
        torch.from_numpy(slots))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    pool = rng.normal(size=(ns, B, nb, dd)).astype(np.float32)
    hop = rng.integers(0, ns, (B, ws)).astype(np.int32)
    pos = rng.integers(0, nb, (B, ws)).astype(np.int32)
    cross = rng.random((B, ws)) < 0.5
    want = je.pool_partner_values(*map(jnp.asarray,
                                       (pool, hop, pos, bx, cross)))
    got = FlatGossipEngine.pool_partner_values(
        *map(torch.from_numpy, (pool, hop, pos, bx, cross)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ------------------------------------------------------------ lag-0 pins

@pytest.mark.parametrize("width", [4224, 40960])
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_norms_independent_of_row_count(dtype, width):
    """A shard's delta norms are bit for bit the same rows' norms among the
    whole (4, 16, D) bank for every worker count, 1 and 3 included, and
    for one world's rows (down to a single (1, D) row), and within rtol
    1e-6 of JAX's fused reduce."""
    rng = np.random.default_rng(width)
    bx = rng.normal(size=(4, 16, width)).astype(np.float32)
    xp = rng.normal(size=(4, 16, width)).astype(np.float32)
    corrupt = np.where(rng.random((4, 16)) < 0.2, 999.0, 0.0) \
        .astype(np.float32)
    tbx, txp = (torch.from_numpy(a).to(dtype) for a in (bx, xp))
    whole = FlatGossipEngine.delta_norms(tbx, txp, torch.from_numpy(corrupt),
                                         axes=2)
    tcor = torch.from_numpy(corrupt)
    for worlds in (slice(0, 4), slice(1, 2)):
        for ws in (1, 2, 3, 4, 8, 16):
            for lo in (0, 16 - ws):
                rows = (worlds, slice(lo, lo + ws))
                part = FlatGossipEngine.delta_norms(
                    tbx[rows].contiguous(), txp[rows].contiguous(),
                    tcor[rows].contiguous(), axes=2)
                assert torch.equal(part, whole[rows]), (worlds, ws, lo)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # jitted, as the JAX replay runs it (XLA drops the bf16 rounding of a
    # difference converted straight to f32)
    ref = np.asarray(jax.jit(lambda a, b, c: JEngine.delta_norms(
        None, a, b, c, axes=2))(jnp.asarray(bx).astype(jdt),
                                jnp.asarray(xp).astype(jdt),
                                jnp.asarray(corrupt)))
    np.testing.assert_allclose(whole.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ns", SHARDS)
@pytest.mark.parametrize("flavor", ["topology", "channel", "defense"])
def test_local_mesh_pins_single_device(flavor, ns, dtype):
    worlds, defenses = _worlds(flavor)
    sim = _sim(robust_rule="trim")
    scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(worlds)]
    f0, t0 = sim.run_worlds(_states(sim, 2, dtype), scheds,
                            defenses=defenses)
    f1, t1 = sim.run_worlds(_states(sim, 2, dtype), scheds,
                            defenses=defenses, mesh=_mesh(ns))
    assert f1.x.dtype == dtype
    _assert_pinned(f0, t0, f1, t1, TRACE_RTOL[dtype])
    if flavor == "defense":
        assert float(t1.defense.rejections.sum()
                     + t1.defense.quarantined.sum()) > 0


@pytest.mark.parametrize("lag", [1, 2])
@pytest.mark.parametrize("flavor", ["topology", "channel"])
def test_lagged_ring_equals_delay_reference(flavor, lag):
    """MeshReplay(lag=L) IS a delay on the boundary: bit for bit the
    single-device replay of shard_lag_schedule(sched, NS, L), also on a
    delay-free schedule (the boundary reads become stale)."""
    worlds, _ = _worlds(flavor)
    sim = _sim()
    scheds = [w.compile(ROUNDS, seed=s + 7) for s, w in enumerate(worlds)]
    f1, t1 = sim.run_worlds(_states(sim, 2), scheds, mesh=_mesh(4, lag))
    f0, t0 = sim.run_worlds(_states(sim, 2), [
        tw.shard_lag_schedule(s, 4, lag) for s in scheds])
    _assert_pinned(f0, t0, f1, t1)
    f2, _ = sim.run_worlds(_states(sim, 2), scheds)
    assert not torch.equal(f2.x, f1.x)   # the lag did change the replay


@pytest.mark.parametrize("dtype", DTYPES)
def test_against_jax_single_device(dtype):
    """The port's 4-shard replay against the JAX package's single-device
    ``run_worlds`` (backend "ref") on a noise-free gradient: f32 within
    rtol 1e-6, bf16 bit for bit."""
    jring = jgr.ring_graph(N)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    target = jnp.asarray(TARGET)
    jworlds = [jw.World(jring), jw.World(jring, channel=jch.ChannelModel(
        delay=jch.DelayProcess(2, prob=0.7)))]

    def jgrad(x, key, wid):
        g = x - target[wid].astype(x.dtype)
        return 0.5 * jnp.sum(g.astype(jnp.float32) ** 2), g

    jsim = JSim(jgrad, jax_params(), 0.05, backend="ref")
    jscheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(jworlds)]
    jf, _ = jsim.run_worlds(
        [jsim.init(jnp.zeros(D, jdt), N, jax.random.PRNGKey(0))
         for _ in jworlds], jscheds)
    sim = _sim(QUIET)
    tscheds = [World.from_json(w.to_json()).compile(ROUNDS, seed=s)
               for s, w in enumerate(jworlds)]
    tf, _ = sim.run_worlds(_states(sim, 2, dtype), tscheds, mesh=_mesh(4))
    for a, b in ((jf.x, tf.x), (jf.x_tilde, tf.x_tilde)):
        want = np.asarray(a.astype(jnp.float32))
        got = b.float().numpy()
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(want, got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_run_schedule_mesh_lift():
    """run_schedule(mesh=) lifts to a B = 1 worlds replay and squeezes:
    |x| bit for bit the serial replay (a signed zero may differ), the
    trace one world's, the defense and telemetry traces squeezed too."""
    ring = ring_graph(N)
    sim = _sim(robust_rule="trim")
    sched = World(topology=ring).compile(ROUNDS, seed=0)
    st = _states(sim, 1)[0]
    f0, t0 = sim.run_schedule(st, sched)
    f1, t1 = sim.run_schedule(_states(sim, 1)[0], sched, mesh=_mesh(4))
    assert t1.loss.shape == (ROUNDS,)
    assert torch.equal(f0.x.abs(), f1.x.abs())
    assert torch.equal(f0.generator.get_state(), f1.generator.get_state())
    byz, defenses = _worlds("defense")
    sched = byz[0].compile(ROUNDS, seed=3)
    f0, t0 = sim.run_schedule(_states(sim, 1)[0], sched,
                              defense=defenses[0], telemetry=Telemetry())
    f1, t1 = sim.run_schedule(_states(sim, 1)[0], sched,
                              defense=defenses[0], telemetry=Telemetry(),
                              mesh=_mesh(2))
    assert torch.equal(f0.x.abs(), f1.x.abs())
    assert t1.defense.tau.shape == t1.telemetry.applied.shape == (ROUNDS,)
    assert all(torch.equal(a, b) for a, b in zip(t0.defense, t1.defense))
    assert torch.equal(t0.telemetry.applied, t1.telemetry.applied)
    assert t1.telemetry.cross_reads.shape == (ROUNDS,)


# ------------------------------------------------- fallback and refusals

def test_ragged_worker_axis_falls_back():
    """n % NS != 0 cannot shard: warn and replay on one device, bitwise
    (a plain callable is then fine)."""
    n_odd = 15

    def quad(x, generator, ids):
        g = x - torch.from_numpy(TARGET[:n_odd])[ids]
        return 0.5 * (g ** 2).sum(dim=1), g

    sim = _sim(quad, n=n_odd)
    scheds = [World(topology=ring_graph(n_odd)).compile(ROUNDS, seed=0)]
    f0, t0 = sim.run_worlds(_states(sim, 1, n=n_odd), scheds)
    with pytest.warns(RuntimeWarning, match="not divisible"):
        f1, t1 = sim.run_worlds(_states(sim, 1, n=n_odd), scheds,
                                mesh=_mesh(2))
    _assert_pinned(f0, t0, f1, t1, rtol=0)


def test_mesh_refusals_and_noop_telemetry():
    sched = [World(topology=ring_graph(N)).compile(ROUNDS, seed=0)]
    sim = _sim()
    with pytest.raises(ValueError, match="flat-buffer engine"):
        sim.run_worlds(_states(sim, 1), sched, engine=False, mesh=_mesh(1))

    def plain(x, generator, ids):   # draws n_rows, not the world's n
        return _apply(x, _draw(generator, ids.shape[0]), ids)

    with pytest.raises(ValueError, match="draw / apply"):
        _sim(plain).run_worlds(_states(sim, 1), sched, mesh=_mesh(2))
    # one shard is the whole world: a plain callable draws what it would
    f0, t0 = _sim(plain).run_worlds(_states(sim, 1), sched)
    f1, t1 = _sim(plain).run_worlds(_states(sim, 1), sched, mesh=_mesh(1))
    _assert_pinned(f0, t0, f1, t1, rtol=0)
    _, tr = sim.run_worlds(_states(sim, 1), sched, mesh=_mesh(2))
    assert tr.telemetry is None
    with pytest.raises(ValueError, match="telemetry"):
        sim.run_worlds(_states(sim, 1), sched, telemetry=object(),
                       mesh=_mesh(2))


def test_cross_shard_byte_split():
    """Under mesh= the telemetry spec takes the shard count: the columns
    (counts, bytes, the intra / cross split) equal the JAX package's
    single-device replay with ``Telemetry(shards=NS)``, which is what its
    sharded replay reports; cross = boundary reads x the row width and
    intra + cross = the surviving reads' bytes."""
    ns = 4
    jring = jgr.ring_graph(N)
    jworld = jw.World(jring, channel=jch.ChannelModel(drop_prob=0.2))
    jsched = jworld.compile(ROUNDS, seed=5)
    target = jnp.asarray(TARGET)

    def jgrad(x, key, wid):
        return 0.5 * jnp.sum((x - target[wid]) ** 2), x - target[wid]

    jsim = JSim(jgrad, jax_params(), 0.05, backend="ref")
    _, jt = jsim.run_worlds([jsim.init(jnp.zeros(D), N,
                                       jax.random.PRNGKey(0))], [jsched],
                            telemetry=jtel.Telemetry(bytes_moved=True,
                                                     shards=ns))
    sim = _sim(QUIET)
    tsched = World.from_json(jworld.to_json()).compile(ROUNDS, seed=5)
    _, t0 = sim.run_worlds(_states(sim, 1), [tsched],
                           telemetry=Telemetry(bytes_moved=True))
    _, t1 = sim.run_worlds(_states(sim, 1), [tsched],
                           telemetry=Telemetry(bytes_moved=True),
                           mesh=_mesh(ns))
    tt0, tt1, jtt = t0.telemetry, t1.telemetry, jt.telemetry
    assert tt0.cross_reads is None and tt0.bytes_cross is None
    for k in ("cross_reads", "bytes_intra", "bytes_cross", "scheduled",
              "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(jtt, k)),
                                      np.asarray(getattr(tt1, k)), err_msg=k)
    for k in ("applied", "rejected", "bytes_moved"):
        np.testing.assert_array_equal(np.asarray(getattr(jtt, k)),
                                      getattr(tt1, k).numpy(), err_msg=k)
        assert torch.equal(getattr(tt0, k), getattr(tt1, k))
    survived = (tt1.scheduled - tt1.dropped) * float(tt1.row_bytes)
    np.testing.assert_array_equal(tt1.bytes_intra + tt1.bytes_cross,
                                  survived)
    np.testing.assert_array_equal(
        tt1.bytes_cross, np.asarray(tt1.cross_reads, np.float64)
        * tt1.row_bytes)
    assert tt1.cross_reads.sum() > 0
    np.testing.assert_array_equal(
        tt1.cross_reads[0], tw.shard_cross_reads(tsched, ns))


# ------------------------------------------------------- mesh plumbing

def test_mesh_replay_validation():
    m = make_replay_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="lag"):
        MeshReplay(m, lag=-1)
    with pytest.raises(ValueError, match="axis"):
        MeshReplay(m, axis="data")
    mr = MeshReplay(m, lag=3)
    assert mr.n_shards == 2
    assert hash(mr) == hash(MeshReplay(make_replay_mesh(
        2, devices=["cpu", "cpu"]), lag=3))
    sim = _sim()
    states = sim.batch_states(_states(sim, 3))
    placed = mr.place_states(states)
    assert len(placed) == 2
    for u, st in enumerate(placed):
        assert st.x.shape == (3, N // 2, D)
        assert torch.equal(st.x, states.x[:, u * 8:(u + 1) * 8])
        assert st.generator is states.generator


def test_make_replay_mesh_sizing_and_errors():
    m = make_replay_mesh(devices=["cpu"] * 3)
    assert isinstance(m, LocalMesh)
    assert m.axis_names == ("worker",) and m.shape == {"worker": 3}
    assert list(m.shards) == [0, 1, 2]
    assert make_replay_mesh(2, devices=["cpu"] * 3).n_shards == 2
    assert make_replay_mesh(1, devices=["cpu"], axis="w").axis_names == \
        ("w",)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="local devices"):
            make_replay_mesh(bad, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        # the entry points default to the card and raise without one
        with pytest.raises(RuntimeError, match="CUDA"):
            make_replay_mesh()
        with pytest.raises(RuntimeError):
            make_rank_mesh()


def test_local_mesh_collectives():
    m = make_replay_mesh(3, devices=["cpu"] * 3)
    blocks = [torch.full((2,), float(u)) for u in range(3)]
    gathered = m.all_gather(blocks)
    assert all(torch.equal(g, torch.stack(blocks)) for g in gathered)
    sums = m.sum(blocks)
    assert all(torch.equal(s, torch.full((2,), 3.0)) for s in sums)


# ---------------------------------------------------------------- ResNet

def test_resnet_sharded_pins_grouped_gradient():
    """A reduced ResNet through ``resnet_grad_fn``'s draw / apply split on
    2 shards: bit for bit the single-device replay whose gradient is
    applied in the shards' row groups (each shard's vmapped call), and
    within 1e-5 of the largest |x| of the default single-device replay (a
    vmap over 2 rows may sum in another order than over 4)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.models.resnet import (init_resnet, resnet8_cifar,
                                           resnet_grad_fn)
    cfg = resnet8_cifar()
    n = 4
    params0 = init_resnet(torch.Generator().manual_seed(0), cfg)
    gfn = resnet_grad_fn(cfg, SyntheticCIFAR(batch_size=2, device="cpu"))
    assert isinstance(gfn, SplitGradFn)

    def grouped_apply(x, batch, ids):
        outs = [gfn.apply(tree_map(lambda a: a[g], x),
                          tree_map(lambda a: a[g], batch), ids[g])
                for g in (slice(0, 2), slice(2, 4))]
        return (torch.cat([o[0] for o in outs]),
                tree_map(lambda *gs: torch.cat(gs), *[o[1] for o in outs]))

    scheds = [World(topology=ring_graph(n)).compile(2, seed=0)]

    def run(fn, mesh=None):
        sim = Simulator(fn, params_from_graph(ring_graph(n), True), 0.05,
                        device="cpu")
        return sim.run_worlds(
            [sim.init(params0, n, torch.Generator().manual_seed(1))], scheds,
            mesh=mesh)

    f0, t0 = run(gfn)
    fg, tg = run(SplitGradFn(gfn.draw, grouped_apply))
    f1, t1 = run(gfn, _mesh(2))
    for a, b in ((fg.x, f1.x), (fg.x_tilde, f1.x_tilde)):
        assert all(torch.equal(u, v)
                   for u, v in zip(tree_leaves(a), tree_leaves(b)))
    assert torch.equal(fg.generator[0].get_state(),
                       f1.generator[0].get_state())
    torch.testing.assert_close(t1.loss, tg.loss, rtol=1e-6, atol=0)
    big = max(a.abs().max().item() for a in tree_leaves(f0.x))
    gap = max((a - b).abs().max().item()
              for a, b in zip(tree_leaves(f0.x), tree_leaves(f1.x)))
    assert gap <= 1e-5 * big


# --------------------------------------------------------------- on a card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_shards_pin_single_device(dtype):
    """Local shards of the card: the delta norms of a shard's rows are
    bit for bit those of the whole bank (PyTorch picks a reduction's split
    from the row count, so rows are summed in fixed blocks), and the channel and
    defense replays on 1, 2, 4, 8 and 16 shards are bit for bit the
    single-device replay, one ``channel_gossip_worlds`` launch a comm step
    a shard."""
    _cuda_or_skip()
    from repro_torch.core import coalesce_schedule, stack_streams
    from repro_torch.kernels.a2cid2_mixing import kernel
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bx = torch.randn(4, 16, 4224, generator=gen, device=dev).to(dtype)
    xp = torch.randn(4, 16, 4224, generator=gen, device=dev).to(dtype)
    corrupt = torch.zeros(4, 16, device=dev)
    whole = FlatGossipEngine.delta_norms(bx, xp, corrupt, axes=2)
    for ws in (1, 2, 4, 8):
        part = FlatGossipEngine.delta_norms(
            bx[:, :ws].contiguous(), xp[:, :ws].contiguous(),
            corrupt[:, :ws].contiguous(), axes=2)
        assert torch.equal(part, whole[:, :ws])

    def draw(generator, n):
        return torch.randn(n, D, generator=generator, device=dev)

    target = torch.from_numpy(TARGET).to(dev)

    def apply(x, noise, ids):
        g = (x - target[ids].to(x.dtype)) + (0.05 * noise).to(x.dtype)
        return 0.5 * (g.float() ** 2).sum(dim=1), g

    sim = Simulator(SplitGradFn(draw, apply),
                    params_from_graph(ring_graph(N), True), 0.05,
                    robust_clip=5.0)
    for flavor in ("channel", "defense"):
        worlds, defenses = _worlds(flavor)
        scheds = [w.compile(ROUNDS, seed=s) for s, w in enumerate(worlds)]
        steps = int((~stack_streams(
            [coalesce_schedule(s) for s in scheds],
            np.zeros((2, N), np.float32)).is_grad).sum())

        def run(mesh=None):
            states = [sim.init(torch.zeros(D, dtype=dtype, device=dev), N,
                               torch.Generator(device=dev).manual_seed(b))
                      for b in range(2)]
            return sim.run_worlds(states, scheds, defenses=defenses,
                                  mesh=mesh)

        f0, t0 = run()
        for ns in (1, 2, 4, 8, 16):
            before = kernel.channel_gossip_worlds.launches
            f1, t1 = run(MeshReplay(make_replay_mesh(ns,
                                                     devices=[dev] * ns)))
            torch.cuda.synchronize()
            assert kernel.channel_gossip_worlds.launches - before \
                == steps * ns
            _assert_pinned(f0, t0, f1, t1, TRACE_RTOL[dtype])
