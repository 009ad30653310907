"""Port parity for the per-worker gossip path: the plain versions of
``p2p_mixing``, ``mixing_p2p`` and the per-worker channel event against the
JAX oracles and the interpret-mode Pallas kernels, the exact identities,
the matching banks (exactly JAX's, without networkx), and
``GossipMixer.gossip_events`` on JAX's own event draws over the single-card
worker axis, plus the SPMD event loop against the stacked one.

Tolerances: f32 rtol 1e-6 (atol 1e-6 near 0): ``exp`` may differ by an ulp
between XLA and PyTorch; everything else is the same sequence of correctly
rounded f32 operations.  bf16: bit for bit (every Python scalar rounded to
bf16 first, as JAX binds a weak scalar).  Banks, rates and corruption
tables: exactly equal.  Baseline (eta = 0) event loops: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchan
from repro.core import gossip as jgossip
from repro.core import graphs as jgraphs
from repro.core import world as jworld
from repro.core.a2cid2 import A2CiD2Params as JParams
from repro.kernels.a2cid2_mixing import kernel as jk
from repro.kernels.a2cid2_mixing import ops as jops
from repro.kernels.a2cid2_mixing import ref as jref
from repro.models import resnet as jres
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import channel as tchan
from repro_torch.core import graphs as tgraphs
from repro_torch.core import world as tworld
from repro_torch.core.a2cid2 import A2CiD2Params, apply_mixing
from repro_torch.core.engine import FlatGossipEngine
from repro_torch.core.gossip import (DelayRing, GossipMixer, WorkerAxis,
                                     bank_corruption, bank_edge_rates,
                                     check_mesh_channel,
                                     consensus_distance_spmd, matching_bank,
                                     phase_banks, world_banks)
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.a2cid2_mixing import kernel as tk
from repro_torch.kernels.a2cid2_mixing import ops as tops
from repro_torch.kernels.a2cid2_mixing.ref import (channel_p2p_mixing_ref,
                                                   mixing_p2p_ref,
                                                   p2p_mixing_ref)

ACID = dict(eta=0.11, alpha=0.5, alpha_t=1.37)
BASE = dict(eta=0.0, alpha=0.5, alpha_t=0.5)
F32 = dict(rtol=1e-6, atol=1e-6)


def _vecs(n, seed, k=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(k)]


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)
            for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _same(port, jax_out, exact):
    for t, j in zip(port, jax_out):
        got, want = t.float().numpy(), np.asarray(j, np.float32)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **F32)


# ------------------------------------------------------- plain versions

@pytest.mark.parametrize("d", [384, 65664])
@pytest.mark.parametrize("dyn", [ACID, dict(eta=0.37, alpha=0.5,
                                             alpha_t=1.37)])
@pytest.mark.parametrize("bf16", [False, True])
def test_p2p_mixing_ref_matches_jax(d, dyn, bf16):
    x, xt, xp = _vecs(d, seed=d)
    dt = np.float32(0.83)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 \
        else (torch.float32, jnp.float32)
    port = p2p_mixing_ref(*_t(x, xt, xp, dtype=tdt), torch.tensor(dt),
                          **dyn)
    jargs = _j(x, xt, xp, dtype=jdt)
    _same(port, jref.p2p_mixing_ref(*jargs, dt, **dyn), bf16)
    # d = 65664 is past the Pallas BLOCK (65536): the JAX kernel pads
    _same(port, jk.p2p_mixing(*jargs, jnp.asarray(dt), interpret=True,
                              **dyn), bf16)


@pytest.mark.parametrize("n", [10, 127, 1_000_003])
@pytest.mark.parametrize("bf16", [False, True])
def test_mixing_p2p_ref_matches_jax(n, bf16):
    x, xt, xp = _vecs(n, seed=n)
    dt = np.float32(0.41)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 \
        else (torch.float32, jnp.float32)
    port = mixing_p2p_ref(*_t(x, xt, xp, dtype=tdt), torch.tensor(dt),
                          **ACID)
    jargs = _j(x, xt, xp, dtype=jdt)
    _same(port, jref.mixing_p2p_ref(*jargs, dt, **ACID), bf16)
    # the Pallas kernel casts 1 - exp(...) before it halves: bit for bit
    # the same at bf16, since halving the f32 value is exact
    _same(port, jk.mixing_p2p(*jargs, jnp.asarray(dt), interpret=True,
                              **ACID), bf16)


@pytest.mark.parametrize("clip", [None, 0.3])
@pytest.mark.parametrize("corrupt,mscale", [(0.0, 1.0), (999.0, 1.0),
                                            (-2.0, 0.25), (0.0, 0.0)])
@pytest.mark.parametrize("bf16", [False, True])
def test_channel_p2p_mixing_ref_matches_jax(clip, corrupt, mscale, bf16):
    x, xt, xp = _vecs(512, seed=7)
    dt = np.float32(0.6)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 \
        else (torch.float32, jnp.float32)
    port = channel_p2p_mixing_ref(*_t(x, xt, xp, dtype=tdt),
                                  torch.tensor(corrupt), torch.tensor(mscale),
                                  torch.tensor(dt), clip=clip, **ACID)
    jargs = _j(x, xt, xp, dtype=jdt)
    _same(port, jref.channel_p2p_mixing_ref(*jargs, corrupt, mscale, dt,
                                            clip=clip, **ACID), bf16)
    _same(port, jops.channel_event_local(*jargs, corrupt, mscale, dt,
                                         clip=clip, backend="pallas_interpret",
                                         **ACID), bf16)


def test_plain_identities_exact():
    x, xt, xp = _t(*_vecs(384, seed=3))
    dt = torch.tensor(0.7)
    # xp = x with eta = 0: a no-op, bit for bit, in both orders
    for fn in (p2p_mixing_ref, mixing_p2p_ref):
        ox, oxt = fn(x, xt, x, dt, **BASE)
        assert torch.equal(ox, x) and torch.equal(oxt, xt)
    # alpha = alpha~ = 0: a pure mixing step
    mx, mxt = apply_mixing(x, xt, ACID["eta"], dt)
    for fn in (p2p_mixing_ref, mixing_p2p_ref):
        ox, oxt = fn(x, xt, xp, dt, eta=ACID["eta"], alpha=0.0,
                     alpha_t=0.0)
        assert torch.equal(ox, mx) and torch.equal(oxt, mxt)
    # the channel event at corrupt 0, mscale 1, no clip is the clean one
    for dtype in (torch.float32, torch.bfloat16):
        a, b, c = (v.to(dtype) for v in (x, xt, xp))
        clean = p2p_mixing_ref(a, b, c, dt, **ACID)
        chan = channel_p2p_mixing_ref(a, b, c, torch.tensor(0.0),
                                      torch.tensor(1.0), dt, **ACID)
        assert all(torch.equal(u, v) for u, v in zip(clean, chan))


@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
def test_gossip_event_pytree_matches_jax_on_resnet8(backend):
    cfg = jres.resnet8_cifar()
    trees = [jax.device_get(jres.init_resnet(jax.random.PRNGKey(s), cfg))
             for s in range(3)]
    jx, jxt = jops.gossip_event_pytree(
        *trees, 0.5, force_pallas=backend != "ref",
        interpret=backend != "ref", **ACID)
    before = tk.mixing_p2p.launches
    tx, txt = tops.gossip_event_pytree(
        *(params_from_jax(t, device="cpu") for t in trees), 0.5, **ACID)
    assert tk.mixing_p2p.launches == before  # the CPU takes the plain one
    for port, want in ((tx, jx), (txt, jxt)):
        got = tree_leaves(params_to_numpy(port))
        exp = jax.tree.leaves(jax.device_get(want))
        assert [g.shape for g in got] == [e.shape for e in exp]
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g, e, **F32)


def test_dispatch_follows_the_tensor_and_wrappers_refuse_cpu():
    x, xt, xp = _t(*_vecs(256, seed=1))
    dt = torch.tensor([0.5])
    counts = (tk.p2p_mixing.launches, tk.mixing_p2p.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.p2p_mixing(x, xt, xp, dt, **ACID)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.mixing_p2p(x, xt, xp, dt, **ACID)
    assert (tk.p2p_mixing.launches, tk.mixing_p2p.launches) == counts
    for fn, ref in ((tops.p2p_mix_event, p2p_mixing_ref),
                    (tops.gossip_event, mixing_p2p_ref)):
        got = fn(x, xt.clone(), xp, dt, **ACID)
        want = ref(x, xt, xp, dt, **ACID)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ the banks

def _graph_pair(kind, n, seed=0):
    if kind == "random":
        rng = np.random.default_rng(seed)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if rng.uniform() < 0.35]
        rng.shuffle(pairs)
        edges = tuple((int(j), int(i)) if rng.uniform() < 0.5
                      else (int(i), int(j)) for i, j in pairs)
        rates = tuple(float(r) for r in rng.uniform(0.2, 2.0, len(edges)))
        return (jgraphs.Graph(n, edges, rates, "random"),
                tgraphs.Graph(n, edges, rates, "random"))
    return (getattr(jgraphs, f"{kind}_graph")(n),
            getattr(tgraphs, f"{kind}_graph")(n))


BANK_GRAPHS = ([("ring", n) for n in (2, 3, 8, 16, 33)]
               + [("torus", s) for s in (2, 3, 4)]
               + [("hypercube", d) for d in (1, 3, 4, 5)]
               + [("complete", n) for n in (2, 5, 8, 12)]
               + [("exponential", n) for n in (4, 8, 16, 24)]
               + [("star", n) for n in (3, 8, 17)]
               + [("random", n) for n in (6, 9, 13, 20, 31)])


@pytest.mark.parametrize("kind,n", BANK_GRAPHS)
def test_matching_bank_equals_jax(kind, n):
    jg, tg = _graph_pair(kind, n, seed=n)
    jb, tb = jgossip.matching_bank(jg), matching_bank(tg)
    assert tb.dtype == np.int32
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(bank_edge_rates(tg, tb),
                                  jgossip.bank_edge_rates(jg, jb))
    # every row an involution; the rows cover every edge exactly once
    assert all((row[row] == np.arange(tg.n)).all() for row in tb)
    covered = sorted((i, int(j)) for row in tb for i, j in enumerate(row)
                     if int(j) > i)
    assert covered == sorted(tuple(sorted(e)) for e in tg.edges)


def test_matching_bank_edgeless_and_isolated_workers():
    # an edgeless graph: one identity row
    jg, tg = (jgraphs.Graph(5, (), (), "none"), tgraphs.Graph(5, (), (),
                                                             "none"))
    np.testing.assert_array_equal(matching_bank(tg),
                                  jgossip.matching_bank(jg))
    np.testing.assert_array_equal(matching_bank(tg),
                                  np.arange(5, dtype=np.int32)[None])
    # a churned phase: isolated workers are idle in every matching
    active = (True, False, True, True, False, True, True, True, False, True)
    jts = jgraphs.TopologySchedule((
        jgraphs.TopologyPhase(jgraphs.exponential_graph(10), 3),
        jgraphs.TopologyPhase(jgraphs.exponential_graph(10), 2, active)))
    tts = tgraphs.TopologySchedule((
        tgraphs.TopologyPhase(tgraphs.exponential_graph(10), 3),
        tgraphs.TopologyPhase(tgraphs.exponential_graph(10), 2, active)))
    jp, tp = jgossip.phase_banks(jts), phase_banks(tts)
    assert len(tp) == len(jp) == 2
    for (tb, tw), (jb, jw) in zip(tp, jp):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tw, jw)
    dead = [i for i, a in enumerate(active) if not a]
    assert (tp[1][0][:, dead] == dead).all()


def test_world_banks_and_bank_corruption_equal_jax():
    g_j, g_t = jgraphs.ring_graph(12), tgraphs.ring_graph(12)
    rates = tuple(float(r) for r in np.linspace(0.5, 2.0, 12))
    jw = jworld.World(topology=g_j, links=jworld.LinkModel(rates=rates),
                      faults=(jworld.ChurnProcess(0.1, 0.3),))
    tw = tworld.World(topology=g_t, links=tworld.LinkModel(rates=rates),
                      faults=(tworld.ChurnProcess(0.1, 0.3),))
    jb, tb = jgossip.world_banks(jw, 30, seed=2), world_banks(tw, 30, seed=2)
    assert len(tb) == len(jb) > 1
    for (a, b), (c, d) in zip(tb, jb):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    bank = matching_bank(g_t)
    for mode, kw in (("scale", dict(scale=1e3)), ("sign_flip", {}),
                     ("zero", {})):
        edges = (g_t.edges[0], g_t.edges[5])
        jadv = jchan.ByzantineEdges(edges, mode, **kw)
        tadv = tchan.ByzantineEdges(edges, mode, **kw)
        np.testing.assert_array_equal(bank_corruption(bank, tadv),
                                      jgossip.bank_corruption(bank, jadv))
    assert not bank_corruption(bank, None).any()


def test_check_mesh_channel_rejects_as_jax():
    cases = [
        (tchan.ChannelModel(delay=tchan.DelayProcess(2)), False,
         "does not emulate message delay"),
        (tchan.ChannelModel(adversary=tchan.ByzantineEdges(((0, 1),),
                                                           prob=0.5)), True,
         "always-on Byzantine"),
        ("not a channel", True, "must be a ChannelModel"),
    ]
    for chan, ring, msg in cases:
        with pytest.raises(ValueError, match=msg):
            check_mesh_channel(chan, permute_ring=ring)
    with pytest.raises(ValueError, match="always-on Byzantine"):
        GossipMixer(tgraphs.ring_graph(4), A2CiD2Params(0.1, 0.5, 0.5, 1.0),
                    channel=cases[1][0])
    check_mesh_channel(None)
    check_mesh_channel(tchan.ChannelModel(delay=tchan.DelayProcess(2)),
                       permute_ring=True)


# ------------------------------------------------------- the event loop

W, E = 8, 6
SHAPES = {"a": (5, 7), "b": (33,)}   # D = 68 real columns, padded to 128


def _stack_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(W,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _rows(tree, w):
    return {k: torch.from_numpy(v[w].copy()) for k, v in tree.items()}


def _mixers(dyn, chan=None, clip=None):
    jg, tg = jgraphs.ring_graph(W), tgraphs.ring_graph(W)
    acid = dict(eta=dyn["eta"], alpha=dyn["alpha"],
                alpha_tilde=dyn["alpha_t"], chi=1.0)
    jc, tc = (None, None) if chan is None else chan
    return (jgossip.GossipMixer(jg, JParams(**acid), backend="ref",
                                channel=jc, robust_clip=clip),
            GossipMixer(tg, A2CiD2Params(**acid), channel=tc,
                        robust_clip=clip))


def _channels(kind):
    if kind == "byzantine_trim":
        edges = ((0, 1), (4, 5))
        return (jchan.ChannelModel(adversary=jchan.ByzantineEdges(
                    edges, "scale", scale=1e3)),
                tchan.ChannelModel(adversary=tchan.ByzantineEdges(
                    edges, "scale", scale=1e3))), 5.0
    if kind == "drops":
        return (jchan.ChannelModel(drop_prob=0.4),
                tchan.ChannelModel(drop_prob=0.4)), None
    if kind.startswith("delay"):
        k = kind.split("_")[1]
        return (jchan.ChannelModel(delay=jchan.DelayProcess(2, 0.7, k)),
                tchan.ChannelModel(delay=tchan.DelayProcess(2, 0.7, k))), None
    return None, None


@pytest.mark.parametrize("kind", ["plain", "byzantine_trim", "drops",
                                  "delay_uniform", "delay_fixed"])
@pytest.mark.parametrize("dyn", [ACID, BASE])
def test_gossip_events_match_jax_on_its_draws(kind, dyn):
    chan, clip = _channels(kind)
    jm, tm = _mixers(dyn, chan, clip)
    key = jax.random.PRNGKey(11)
    idxs, dts = jm.sample_event_batch(key, E)
    stale = jm.sample_stale(jax.random.PRNGKey(12), E) \
        if jm.delay is not None else None
    if kind == "drops":
        assert (np.asarray(idxs) < 0).any()
    x, xt = _stack_tree(1), _stack_tree(2)
    d = FlatGossipEngine.for_pytree(_rows(x, 0), tm.params, stacked=False
                                    ).layout.d
    rng = np.random.default_rng(3)
    buf = rng.normal(size=(W, 2, d)).astype(np.float32)
    buf[:, :, 68:] = 0
    rnd = 1

    def j_run(x_, xt_, buf_):
        ring = None if stale is None else jgossip.DelayRing(
            buf_, jnp.asarray(rnd, jnp.int32))
        return jm.gossip_events(x_, xt_, idxs, dts, ring=ring, stale=stale)

    jx, jxt = jax.device_get(jax.vmap(j_run, axis_name="worker")(
        x, xt, jnp.asarray(buf)))
    rings = None if stale is None else [
        DelayRing(torch.from_numpy(buf[w].copy()), rnd) for w in range(W)]
    tx, txt = tm.gossip_events([_rows(x, w) for w in range(W)],
                               [_rows(xt, w) for w in range(W)],
                               np.asarray(idxs), torch.from_numpy(
                                   np.array(dts)), rings=rings,
                               stale=None if stale is None
                               else np.asarray(stale))
    exact = dyn["eta"] == 0.0 and clip is None
    for w in range(W):
        for port, want in ((tx[w], jx), (txt[w], jxt)):
            for k in SHAPES:
                got, exp = port[k].numpy(), want[k][w]
                if exact:
                    np.testing.assert_array_equal(got, exp)
                else:
                    np.testing.assert_allclose(got, exp, **F32)


def test_each_event_partner_map_is_an_involution():
    for graph in (tgraphs.ring_graph(16), tgraphs.exponential_graph(16),
                  tgraphs.torus_graph(4), tgraphs.complete_graph(7)):
        mixer = GossipMixer(graph, A2CiD2Params(0.1, 0.5, 0.5, 1.0),
                            channel=tchan.ChannelModel(drop_prob=0.2))
        idxs, gaps = mixer.sample_event_batch(
            torch.Generator().manual_seed(graph.n), 64)
        assert idxs.dtype == torch.int32 and idxs.shape == (64,)
        assert gaps.shape == (64,) and bool((gaps > 0).all())
        assert int(idxs.min()) >= -1 and int(idxs.max()) < len(mixer.bank)
        for idx in idxs.tolist():
            p = mixer.bank[max(idx, 0)]
            assert (p[p] == np.arange(graph.n)).all()
            # the permute hands worker i exactly its partner's value
            got = mixer.axis.ppermute(list(range(graph.n)),
                                      mixer._perm(max(idx, 0)))
            assert got == list(p)


def test_spmd_event_loop_equals_the_stacked_loop_per_row():
    """On shared gaps the per-worker loop (one p2p_mixing per worker) is
    bit for bit the stacked loop (one mixing_gossip_stacked per event)."""
    _, tm = _mixers(ACID)
    idxs, gaps = tm.sample_event_batch(torch.Generator().manual_seed(5), E)
    x, xt = _stack_tree(4), _stack_tree(5)
    xs = [_rows(x, w) for w in range(W)]
    xts = [_rows(xt, w) for w in range(W)]
    sx, sxt = tm.gossip_events(xs, xts, idxs, gaps)
    engine = FlatGossipEngine.for_pytree(
        {k: torch.from_numpy(v) for k, v in x.items()}, tm.params)
    bx = engine.pack({k: torch.from_numpy(v) for k, v in x.items()})
    bxt = engine.pack({k: torch.from_numpy(v) for k, v in xt.items()})
    shared = gaps[:, None].expand(E, W).contiguous()
    bx, bxt = engine.mix(bx, bxt, shared[0])
    nxt = torch.cat([shared[1:], torch.zeros(1, W)])
    for e, idx in enumerate(idxs.tolist()):
        bx, bxt = engine.batch(bx, bxt, torch.from_numpy(tm.bank[idx]),
                               nxt[e])
    local = FlatGossipEngine.for_pytree(xs[0], tm.params, stacked=False)
    for w in range(W):
        assert torch.equal(local.pack_local(sx[w]), bx[w])
        assert torch.equal(local.pack_local(sxt[w]), bxt[w])


def test_worker_axis_collectives_and_consensus():
    axis = WorkerAxis(4)
    vals = [torch.full((3,), float(w)) for w in range(4)]
    out = axis.ppermute(vals, [(0, 1), (1, 0), (2, 3)])
    assert out[0] is vals[1] and out[1] is vals[0] and out[3] is vals[2]
    assert torch.equal(out[2], torch.zeros(3))  # not a destination
    assert torch.equal(axis.psum(vals), torch.full((3,), 6.0))
    trees = [{"a": v, "b": (2 * v,)} for v in vals]
    mean = axis.pmean(trees)
    assert torch.equal(mean["a"], torch.full((3,), 1.5))
    assert torch.equal(mean["b"][0], torch.full((3,), 3.0))
    x = _stack_tree(6)
    want = jax.vmap(jgossip.consensus_distance_spmd, axis_name="worker")(x)
    got = consensus_distance_spmd([_rows(x, w) for w in range(W)])
    np.testing.assert_allclose(float(got), float(want[0]), rtol=1e-6)


# ----------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_p2p_mixing_matches_plain(dtype):
    dev = _cuda()
    x, xt, xp = (t.to(dev, dtype) for t in _t(*_vecs(16512, seed=9)))
    x[16000:], xt[16000:], xp[16000:] = 0, 0, 0
    dts = torch.tensor([0.3, 0.9], device=dev)
    rx, rxt = p2p_mixing_ref(x, xt, xp, dts[1], **ACID)
    kxt_in = xt.clone()
    before = tk.p2p_mixing.launches
    kx, kxt = tk.p2p_mixing(x, kxt_in, xp, dts[1], **ACID)
    torch.cuda.synchronize()
    assert tk.p2p_mixing.launches == before + 1
    assert kxt.data_ptr() == kxt_in.data_ptr()  # x~ updated in place
    assert torch.equal(kx, rx) and torch.equal(kxt, rxt)
    assert bool((kx[16000:] == 0).all() and (kxt[16000:] == 0).all())
    # xp = x with eta = 0: untouched
    kx0, kxt0 = tk.p2p_mixing(x, xt.clone(), x, dts[0], **BASE)
    assert torch.equal(kx0, x) and torch.equal(kxt0, xt)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.p2p_mixing(x[:100], xt[:100], xp[:100], dts[0], **ACID)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(10, 0), (127, 0), (1_000_003, 0),
                                      (4099, 1), (4099, 3)])
def test_cuda_mixing_p2p_matches_plain(dtype, n, offset):
    dev = _cuda()
    base = [t.to(dev, dtype) for t in _t(*_vecs(n + 8, seed=n))]
    x, xt, xp = (b[offset:offset + n] for b in base)  # misaligned views
    dt = torch.tensor(0.45, device=dev)
    rx, rxt = mixing_p2p_ref(x, xt, xp, dt, **ACID)
    kx, kxt = tk.mixing_p2p(x, xt, xp, dt, **ACID)
    torch.cuda.synchronize()
    assert torch.equal(kx, rx) and torch.equal(kxt, rxt)
    # the inputs are left as they were
    assert torch.equal(x, base[0][offset:offset + n])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [None, 0.3])
@pytest.mark.parametrize("corrupt,mscale", [(0.0, 1.0), (999.0, 1.0),
                                            (-2.0, 0.25), (999.0, 0.0)])
def test_cuda_channel_event_local_matches_plain(dtype, clip, corrupt, mscale):
    dev = _cuda()
    x, xt, xp = (t.to(dev, dtype) for t in _t(*_vecs(16512, seed=13)))
    # 0-dim f32 scalars on the card, as engine.channel_batch_local gives
    c, s, dt = (torch.tensor(v, device=dev) for v in (corrupt, mscale, 0.7))
    rx, rxt = tops.channel_event_local(x, xt, xp, c, s, dt, clip=clip,
                                       backend="ref", **ACID)
    kxt_in = xt.clone()
    before = tk.channel_gossip_stacked.launches
    kx, kxt = tops.channel_event_local(x, kxt_in, xp, c, s, dt, clip=clip,
                                       **ACID)
    torch.cuda.synchronize()
    assert tk.channel_gossip_stacked.launches == before + 1
    assert kx.shape == x.shape and kxt.data_ptr() == kxt_in.data_ptr()
    assert torch.equal(kx, rx) and torch.equal(kxt, rxt)


@pytest.mark.gpu
@pytest.mark.parametrize("rule,tau", [("trim", 50.0), ("clip", 5.0),
                                      ("coord", 0.3)])
def test_cuda_spmd_channel_events_match_plain(monkeypatch, rule, tau):
    """Whole SPMD channel events on the card (per-worker robust scales
    computed there) equal the same events through the plain version."""
    import functools
    from repro_torch.core import engine as tengine
    dev = _cuda()
    (_, tc), _ = _channels("byzantine_trim")
    mixer = GossipMixer(tgraphs.ring_graph(W), A2CiD2Params(
        eta=ACID["eta"], alpha=ACID["alpha"], alpha_tilde=ACID["alpha_t"],
        chi=1.0), channel=tc, robust_clip=tau, robust_rule=rule)
    assert mixer.bank_corrupt.any()
    idxs = np.array(list(range(mixer.bank.shape[0])) + [-1], np.int32)
    dts = torch.tensor([0.2, 0.5, 0.3, 0.4][:len(idxs)])
    x, xt = _stack_tree(21), _stack_tree(22)

    def run():
        xs = [{k: v.to(dev) for k, v in _rows(x, w).items()}
              for w in range(W)]
        xts = [{k: v.to(dev) for k, v in _rows(xt, w).items()}
               for w in range(W)]
        return mixer.gossip_events(xs, xts, idxs, dts)

    before = tk.channel_gossip_stacked.launches
    kx, kxt = run()
    torch.cuda.synchronize()
    assert tk.channel_gossip_stacked.launches == before + len(idxs) * W
    monkeypatch.setattr(tengine, "channel_event_local", functools.partial(
        tops.channel_event_local, backend="ref"))
    rx, rxt = run()
    assert tk.channel_gossip_stacked.launches == before + len(idxs) * W
    for w in range(W):
        for k in SHAPES:
            assert torch.equal(kx[w][k], rx[w][k])
            assert torch.equal(kxt[w][k], rxt[w][k])
