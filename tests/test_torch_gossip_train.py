"""Port parity for the gossip trainers: ``GossipTrainer`` (the per-worker
SPMD step, here over the single-card ``WorkerAxis``) against the JAX
package's step under ``jax.vmap(..., axis_name="worker")`` with the PRNG key
replicated (so the event draws are shared, as on a mesh), and
``StackedGossipTrainer`` (plain, channel and delay flavours, the pair-ring
step and both AR steps) against the JAX package's, on JAX's own draws
handed to the port's draw-then-apply seam.

Models: a noise-free quadratic and ResNet-8 with ``convert``-carried
weights and host-drawn batches; 8 workers on a ring; 2-3 steps.

Tolerance: every leaf of x, x~, the optimizer state, t_last and the ring
within max|d| / max|ref| < 1e-5 (the relative measure the LM model tests
use for model tensors: XLA and PyTorch sum convolutions, norms and means in
other orders).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchan
from repro.core import graphs as jgraphs
from repro.core import world as jworld
from repro.core.a2cid2 import params_from_graph as j_params_from_graph
from repro.launch import gossip_train as jgt
from repro.models import resnet as jres
from repro.optim import optimizers as jopt
from repro_torch.convert import (gossip_state_from_jax, params_from_jax,
                                 stacked_state_from_jax)
from repro_torch.core import channel as tchan
from repro_torch.core import graphs as tgraphs
from repro_torch.core import world as tworld
from repro_torch.core.a2cid2 import params_from_graph
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.a2cid2_mixing import kernel as tk
from repro_torch.launch import gossip_train as tgt
from repro_torch.models import resnet as tres
from repro_torch.optim import optimizers as topt

W, D, STEPS, REL = 8, 40, 3, 1e-5


# --------------------------------------------------------------- helpers

def _close(port, want, what):
    got = [np.asarray(a, np.float64) for a in port]
    exp = [np.asarray(a, np.float64) for a in want]
    assert len(got) == len(exp), what
    for g, e in zip(got, exp):
        assert g.shape == e.shape, (what, g.shape, e.shape)
        scale = np.abs(e).max()
        err = np.abs(g - e).max()
        assert err <= REL * scale if scale > 0 else err == 0, \
            f"{what}: max|d| {err} against max|ref| {scale}"


def _np(tree):
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _jnp(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _compare_spmd(tstate, jstate, tm=None, jm=None):
    g = tgt.stack_workers(tstate)
    j = jax.device_get(jstate)
    _close(_np(g.params), _jnp(j.params), "x")
    _close(_np(g.momentum), _jnp(j.momentum), "x~")
    _close(_np(g.opt.mu), _jnp(j.opt.mu), "opt.mu")
    assert g.opt.step.tolist() == np.asarray(j.opt.step).tolist()
    _close([g.t_last.numpy()], [np.asarray(j.t_last)], "t_last")
    assert (g.ring is None) == (j.ring is None)
    if g.ring is not None:
        _close([g.ring.buf.numpy()], [np.asarray(j.ring.buf)], "ring")
        assert g.ring.round.tolist() == np.asarray(j.ring.round).tolist()
    if tm is not None:
        _close([tm["loss"].detach().numpy()],
               [np.asarray(jm["loss"])[0]], "loss")


def _compare_stacked(tstate, jstate):
    j = jax.device_get(jstate)
    _close(_np(tstate.x), _jnp(j.x), "x")
    _close(_np(tstate.x_tilde), _jnp(j.x_tilde), "x~")
    _close(_np(tstate.opt.mu), _jnp(j.opt.mu), "opt.mu")
    assert tstate.opt.step.tolist() == np.asarray(j.opt.step).tolist()
    assert (tstate.ring is None) == (j.ring is None)
    if tstate.ring is not None:
        _close([tstate.ring.buf.numpy()], [np.asarray(j.ring.buf)], "ring")
        assert tstate.ring.round == int(j.ring.round)


def _spmd_draws(jtr, key):
    """The draws the JAX per-worker step takes from ``key`` (its own code
    path, replayed on the host)."""
    mixer = jtr._mixer()
    k_st = None
    if mixer.delay is not None:
        key, k_st = jax.random.split(key)
    key, k_ev, k_dt = jax.random.split(key, 3)
    dt = jnp.stack([jax.random.exponential(jax.random.fold_in(k_dt, w), ())
                    for w in range(W)])
    if jtr.grad_rates is not None:
        dt = dt / jnp.asarray(jtr.grad_rates, jnp.float32)
    idxs, gaps = mixer.sample_event_batch(k_ev, jtr.comms_per_step)
    stale = None if k_st is None else \
        torch.from_numpy(np.array(mixer.sample_stale(k_st,
                                                     jtr.comms_per_step)))
    return tgt.GossipDraws(*(torch.from_numpy(np.array(a))
                             for a in (dt, idxs, gaps)), stale)


def _stacked_draws(jtr, key):
    from repro.core.gossip import bank_edge_rates, matching_bank
    bank = matching_bank(jtr.graph)
    probs = jnp.asarray(bank_edge_rates(jtr.graph, bank), jnp.float32)
    e = jtr.comms_per_step
    chan = jtr.channel
    delay = None if chan is None or chan.delay is None \
        or chan.delay.is_trivial else chan.delay
    drop = 0.0 if chan is None else chan.drop_prob
    k_st = None
    if delay is not None:
        key, k_st = jax.random.split(key)
    key, k_dt, k_ev, k_gap = jax.random.split(key, 4)
    dts = jax.random.exponential(k_dt, (W,))
    k_drop = None
    if drop > 0.0:
        k_ev, k_drop = jax.random.split(k_ev)
    idxs = jax.random.categorical(k_ev, jnp.log(probs), shape=(e,))
    gaps = jax.random.exponential(k_gap, (e, W)) / max(e, 1)
    stales = None
    if delay is not None:
        k1, k2 = jax.random.split(k_st)
        hit = jax.random.bernoulli(k1, delay.prob, (e, W))
        offs = jnp.full((e, W), delay.horizon, jnp.int32) \
            if delay.kind == "fixed" else jax.random.randint(
                k2, (e, W), 1, delay.horizon + 1, dtype=jnp.int32)
        stales = torch.from_numpy(np.array(jnp.where(hit, offs, 0)))
    if k_drop is not None:
        dropped = jax.random.bernoulli(k_drop, drop, (e,))
        idxs = jnp.where(dropped, -1, idxs)
    return tgt.StackedDraws(*(torch.from_numpy(np.array(a)) for a in
                              (dts, idxs.astype(jnp.int32), gaps)), stales)


def _pair_ring_draws(key):
    _, k_dt, k_ev, k_gap = jax.random.split(key, 4)
    e = 2
    return tgt.PairRingDraws(
        torch.from_numpy(np.array(jax.random.exponential(k_dt, (W,)))),
        torch.from_numpy(np.array(jax.random.bernoulli(k_ev, 0.5, (e,)))),
        torch.from_numpy(np.array(jax.random.exponential(k_gap, (e, W))
                                  / e)))


# ----------------------------------------------------------------- models

def _quadratic():
    b = np.random.default_rng(0).normal(size=(W, D)).astype(np.float32)

    def j_loss(p, batch):
        return 0.5 * jnp.sum((p["w"] - batch) ** 2), {}

    def t_loss(p, batch):
        return 0.5 * ((p["w"] - batch) ** 2).sum(), {}

    def j_grad(p, batch):
        return (0.5 * jnp.sum((p["w"] - batch) ** 2), None), \
            {"w": p["w"] - batch}

    def t_grad(p, batch):
        return (0.5 * ((p["w"] - batch) ** 2).sum(), None), \
            {"w": p["w"] - batch}

    p0 = {"w": np.linspace(-1.0, 1.0, D, dtype=np.float32)}
    return dict(j_loss=j_loss, t_loss=t_loss, j_grad=j_grad, t_grad=t_grad,
                params=p0, batches=[b] * STEPS)


@functools.cache
def _resnet8():
    jcfg, tcfg = jres.resnet8_cifar(), tres.resnet8_cifar()
    rng = np.random.default_rng(1)
    batches = [{"images": rng.normal(size=(W, 2, 32, 32, 3)).astype(
                    np.float32),
                "labels": rng.integers(0, 10, (W, 2)).astype(np.int32)}
               for _ in range(2)]

    def j_grad(p, batch):
        (loss, m), g = jax.value_and_grad(
            lambda q: jres.resnet_loss(q, jcfg, batch), has_aux=True)(p)
        return (loss, m), g

    def t_grad(p, batch):
        g, (loss, m) = torch.func.grad_and_value(
            lambda q: tres.resnet_loss(q, tcfg, batch), has_aux=True)(p)
        return (loss, m), g

    return dict(j_loss=lambda p, b: jres.resnet_loss(p, jcfg, b),
                t_loss=lambda p, b: tres.resnet_loss(p, tcfg, b),
                j_grad=j_grad, t_grad=t_grad,
                params=jax.device_get(jres.init_resnet(
                    jax.random.PRNGKey(0), jcfg)),
                batches=batches)


def _tbatch(b):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), b)


def _channels(kind):
    g = jgraphs.ring_graph(W)
    if kind == "channel":
        edges = (g.edges[0], g.edges[3])
        return (jchan.ChannelModel(
                    adversary=jchan.ByzantineEdges(edges, "scale",
                                                   scale=1e3),
                    drop_prob=0.3, delay=jchan.DelayProcess(2)),
                tchan.ChannelModel(
                    adversary=tchan.ByzantineEdges(edges, "scale",
                                                   scale=1e3),
                    drop_prob=0.3, delay=tchan.DelayProcess(2)), 20.0)
    if kind == "delay":
        return (jchan.ChannelModel(delay=jchan.DelayProcess(2, 0.8)),
                tchan.ChannelModel(delay=tchan.DelayProcess(2, 0.8)), None)
    return None, None, None


# ---------------------------------------------------------- SPMD trainer

def _spmd_pair(model, accel, kind="plain", comms=3):
    jc, tc, clip = _channels(kind)
    jg, tg = jgraphs.ring_graph(W), tgraphs.ring_graph(W)
    kw = dict(lr=0.1, comms_per_step=comms, robust_clip=clip)
    jtr = jgt.GossipTrainer(model["j_loss"], jopt.sgd(), jg,
                            j_params_from_graph(jg, accel), backend="ref",
                            channel=jc, **kw)
    ttr = tgt.GossipTrainer(model["t_loss"], topt.sgd(), tg,
                            params_from_graph(tg, accel), channel=tc, **kw)
    return jtr, ttr


def _spmd_init(jtr, model):
    stack = jax.tree.map(lambda a: np.broadcast_to(a, (W,) + np.shape(a)),
                         model["params"])
    jstate = jax.vmap(jtr.init, in_axes=(0, None))(
        stack, jax.random.PRNGKey(3))
    tstate = gossip_state_from_jax(jax.device_get(jstate),
                                   torch.Generator(), device="cpu")
    return jstate, tstate


@pytest.mark.parametrize("model,accel,kind", [
    ("quadratic", False, "plain"), ("quadratic", True, "plain"),
    ("quadratic", True, "channel"), ("quadratic", True, "delay"),
    ("resnet8", True, "plain")])
def test_spmd_step_matches_jax_vmap(model, accel, kind):
    m = _quadratic() if model == "quadratic" else _resnet8()
    jtr, ttr = _spmd_pair(m, accel, kind)
    jstate, tstate = _spmd_init(jtr, m)
    jstep = jax.jit(jax.vmap(jtr.make_step(None), axis_name="worker"))
    tstep = ttr.make_step()
    before = (tk.p2p_mixing.launches, tk.channel_gossip_stacked.launches)
    for b in m["batches"]:
        draws = _spmd_draws(jtr, jstate.key[0])
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b), draws)
        _compare_spmd(tstate, jstate, tm, jm)
    # the CPU takes the plain versions: no kernel launches
    assert (tk.p2p_mixing.launches,
            tk.channel_gossip_stacked.launches) == before


def test_spmd_ar_step_and_shard_mapped_step_match_jax():
    m = _quadratic()
    jtr, ttr = _spmd_pair(m, True)
    jstate, tstate = _spmd_init(jtr, m)
    # desynchronize the workers first: two gossip steps
    jstep = jax.vmap(jtr.make_step(None), axis_name="worker")
    tstep = ttr.shard_mapped_step(ttr.make_step())
    global_view = tgt.stack_workers(tstate)
    for b in m["batches"][:2]:
        draws = _spmd_draws(jtr, jstate.key[0])
        jstate, _ = jstep(jstate, b)
        global_view, _ = tstep(global_view, _tbatch(b), draws)
    tstate = tgt.unstack_workers(global_view)
    _compare_spmd(tstate, jstate)
    jar = jax.vmap(jtr.make_ar_step(), axis_name="worker")
    tar = ttr.make_ar_step()
    for b in m["batches"][:2]:
        jstate, jm = jar(jstate, b)
        tstate, tm = tar(tstate, _tbatch(b))
        _compare_spmd(tstate, jstate, tm, jm)


def test_spmd_step_draws_its_own_events_on_the_cpu():
    """Without draws the step samples them from the state's generator;
    every worker reads the same events, and the state stays finite."""
    m = _quadratic()
    _, ttr = _spmd_pair(m, True, "channel", comms=2)
    state = ttr.init(params_from_jax(m["params"], device="cpu"),
                     torch.Generator().manual_seed(0))
    assert len(state.ring) == W and state.ring[0].round == -1
    step = ttr.make_step()
    for b in m["batches"]:
        state, metrics = step(state, _tbatch(b))
    assert state.ring[0].round == STEPS - 1
    assert all(bool(torch.isfinite(x["w"]).all()) for x in state.params)
    assert bool(torch.isfinite(metrics["loss"]))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        ttr.init(params_from_jax(m["params"], device="cpu"),
                 types.SimpleNamespace(device=torch.device("cuda")))


# -------------------------------------------------------- stacked trainer

def _stacked_pair(model, accel, kind="plain", comms=3):
    jc, tc, clip = _channels(kind)
    jg, tg = jgraphs.ring_graph(W), tgraphs.ring_graph(W)
    kw = dict(lr=0.1, comms_per_step=comms, robust_clip=clip)
    jtr = jgt.StackedGossipTrainer(model["j_grad"], jopt.sgd(), jg,
                                   j_params_from_graph(jg, accel),
                                   backend="ref", channel=jc, **kw)
    ttr = tgt.StackedGossipTrainer(model["t_grad"], topt.sgd(), tg,
                                   params_from_graph(tg, accel), channel=tc,
                                   **kw)
    jstate = jtr.init(jax.tree.map(jnp.asarray, model["params"]),
                      jax.random.PRNGKey(4))
    tstate = stacked_state_from_jax(jax.device_get(jstate),
                                    torch.Generator(), device="cpu")
    return jtr, ttr, jstate, tstate


@pytest.mark.parametrize("model,accel,kind", [
    ("quadratic", False, "plain"), ("quadratic", True, "plain"),
    ("quadratic", True, "channel"), ("quadratic", True, "delay"),
    ("resnet8", True, "plain")])
def test_stacked_step_matches_jax(model, accel, kind):
    m = _quadratic() if model == "quadratic" else _resnet8()
    jtr, ttr, jstate, tstate = _stacked_pair(m, accel, kind)
    jstep = jax.jit(jtr.make_step())
    tstep = ttr.make_step()
    for b in m["batches"]:
        draws = _stacked_draws(jtr, jstate.key)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b), draws)
        _compare_stacked(tstate, jstate)
        _close([tm["loss"].detach().numpy()], [np.asarray(jm["loss"])],
               "loss")


def test_pair_ring_and_ar_steps_match_jax():
    m = _quadratic()
    jtr, ttr, jstate, tstate = _stacked_pair(m, True, comms=2)
    jpair, tpair = jax.jit(jtr.make_pair_ring_step()), \
        ttr.make_pair_ring_step()
    for b in m["batches"]:
        draws = _pair_ring_draws(jstate.key)
        jstate, _ = jpair(jstate, b)
        tstate, _ = tpair(tstate, _tbatch(b), draws)
        _compare_stacked(tstate, jstate)
    jar, tar = jax.jit(jtr.make_ar_step()), ttr.make_ar_step()
    for b in m["batches"][:2]:
        jstate, _ = jar(jstate, b)
        tstate, _ = tar(tstate, _tbatch(b))
        _compare_stacked(tstate, jstate)
    with pytest.raises(ValueError, match="ring of an even"):
        tgt.StackedGossipTrainer(m["t_grad"], topt.sgd(),
                                 tgraphs.ring_graph(5),
                                 params_from_graph(tgraphs.ring_graph(5))
                                 ).make_pair_ring_step()


def test_stacked_step_draws_its_own_events_on_the_cpu():
    m = _quadratic()
    _, ttr, _, _ = _stacked_pair(m, True, "channel", comms=2)
    state = ttr.init(params_from_jax(m["params"], device="cpu"),
                     torch.Generator().manual_seed(1))
    assert state.opt.step.shape == (W,) and state.ring.round == -1
    step = ttr.make_step()
    for b in m["batches"]:
        state, metrics = step(state, _tbatch(b))
    assert state.ring.round == STEPS - 1
    assert bool(torch.isfinite(state.x["w"]).all())
    assert state.opt.step.tolist() == [STEPS] * W


# -------------------------------------------------- construction checks

def test_from_world_and_rejections_match_jax():
    jg, tg = jgraphs.ring_graph(W), tgraphs.ring_graph(W)
    rates = (0.5,) * W
    jw = jworld.World(topology=jg, comms_per_grad=3,
                      workers=jworld.WorkerModel(grad_rates=rates))
    tw = tworld.World(topology=tg, comms_per_grad=3,
                      workers=tworld.WorkerModel(grad_rates=rates))
    m = _quadratic()
    for jcls, tcls, fn in ((jgt.GossipTrainer, tgt.GossipTrainer, "loss"),
                           (jgt.StackedGossipTrainer,
                            tgt.StackedGossipTrainer, "grad")):
        j = jcls.from_world(jw, m[f"j_{fn}"], jopt.sgd())
        t = tcls.from_world(tw, m[f"t_{fn}"], topt.sgd())
        assert (t.comms_per_step, t.grad_rates) == (j.comms_per_step,
                                                    j.grad_rates)
        assert (t.acid.eta, t.acid.alpha, t.acid.alpha_tilde) == \
            (j.acid.eta, j.acid.alpha, j.acid.alpha_tilde)
        t = tcls.from_world(tw, m[f"t_{fn}"], topt.sgd(), accelerated=False)
        assert t.acid.eta == 0.0
    # fractional comm rates, phased worlds, duty-cycled adversaries and
    # mis-sized rate vectors raise as in JAX
    with pytest.raises(ValueError, match="not an integer"):
        tgt.GossipTrainer.from_world(
            tworld.World(topology=tg, comms_per_grad=1.5), m["t_loss"],
            topt.sgd())
    with pytest.raises(ValueError, match="static_graph"):
        tgt.GossipTrainer.from_world(
            tworld.World(topology=tg, faults=(tworld.ChurnProcess(0.1,
                                                                  0.1),)),
            m["t_loss"], topt.sgd())
    with pytest.raises(ValueError, match="always-on Byzantine"):
        tgt.StackedGossipTrainer(
            m["t_grad"], topt.sgd(), tg, params_from_graph(tg),
            channel=tchan.ChannelModel(adversary=tchan.ByzantineEdges(
                (tg.edges[0],), prob=0.5)))
    with pytest.raises(ValueError, match="grad_rates must have"):
        tgt._rate_vec((1.0,) * (W - 1), W)
    assert tgt._rate_vec(None, W) is None
