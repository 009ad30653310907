"""Port parity for the unreliable-channel slice.

  * compiled channel schedules (partners, event mask, stale/corrupt/drop
    extras) are EXACTLY the JAX package's, over several channels and seeds;
  * the snapshot ring matches the JAX ring and owns its storage;
  * the plain channel kernel matches the JAX Pallas kernel (interpret mode)
    and the JAX oracle at f32 and bf16, with and without a coordinate clip
    and the rejection mask;
  * ``run_schedule`` on the hostile channel matches the JAX package's
    ``run_schedule(backend="ref")`` for every robust rule, on the engine
    and the per-event path;
  * the exact reductions: a zero corrupt mask and a horizon-0 delay replay
    bitwise like the clean path;
  * on a card (``-m gpu``), the CUDA kernel against the plain version, its
    rejection mask, and its bitwise degeneration to the clean kernel.

Tolerances: replays rtol 1e-5 / atol 1e-6 (the same f32 operations, but
reductions and ``exp`` may round differently); the kernel at f32 rtol 1e-6
/ atol 1e-6; at bf16 bit for bit, since the port rounds every Python scalar
(alpha, alpha~, gamma, the clip) to bf16 before it multiplies a bf16 tensor,
as JAX binds a weak scalar (``ref.dtype_scalar``), so both round at the
same places.  The per-event p2p and gradient steps are held bit for bit
against the JAX package's at bf16 too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ByzantineEdges as JByz
from repro.core import ChannelModel as JChannel
from repro.core import DelayProcess as JDelay
from repro.core import A2CiD2Params as JParams
from repro.core import Simulator as JSim
from repro.core import gradient_event as j_gradient_event
from repro.core import matched_p2p_update as j_matched_p2p
from repro.core import degradation_profile as j_degradation
from repro.core import make_schedule as j_make_schedule
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro.core.flatbuf import ring_read as j_ring_read
from repro.kernels.a2cid2_mixing.kernel import \
    channel_gossip_stacked as j_kernel
from repro.kernels.a2cid2_mixing.ref import \
    channel_gossip_stacked_ref as j_ref
from repro_torch.core import (A2CiD2Params, ByzantineEdges, ChannelModel,
                              DelayProcess, Simulator, degradation_profile,
                              gradient_event, has_channel_extras,
                              make_schedule, matched_p2p_update,
                              params_from_graph, ring_graph)
from repro_torch.core.channel import CORRUPT_KEY, DROP_KEY, STALE_KEY
from repro_torch.core.flatbuf import ring_init, ring_push, ring_read
from repro_torch.kernels.a2cid2_mixing import kernel as t_kernel
from repro_torch.kernels.a2cid2_mixing.ops import channel_event_stacked
from repro_torch.kernels.a2cid2_mixing.ref import (
    channel_gossip_stacked_ref, mixing_gossip_stacked_ref)

N, DIM, ROUNDS, GAMMA = 12, 16, 20, 0.05
B = np.random.default_rng(7).normal(size=(N, DIM)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_F32 = dict(rtol=1e-6, atol=1e-6)
ACID = dict(eta=0.37, alpha=0.5, alpha_t=1.37)


def _channels(mod, edges):
    """The same channel family built from either package's classes."""
    Chan, Delay, Byz = mod
    return {
        "delay_uniform": Chan(delay=Delay(horizon=3, prob=0.6)),
        "delay_fixed": Chan(delay=Delay(horizon=2, prob=1.0, kind="fixed")),
        "sign_flip": Chan(adversary=Byz(edges[:2], "sign_flip")),
        "zero_duty": Chan(adversary=Byz(edges[:3], "zero", prob=0.5)),
        "scale": Chan(adversary=Byz(edges[:2], "scale", scale=1e3,
                                    prob=0.5)),
        "drops": Chan(drop_prob=0.2),
        "hostile": Chan(delay=Delay(horizon=3, prob=0.6),
                        adversary=Byz(edges[:2], "sign_flip"),
                        drop_prob=0.1),
    }


J_MOD = (JChannel, JDelay, JByz)
T_MOD = (ChannelModel, DelayProcess, ByzantineEdges)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["delay_uniform", "delay_fixed",
                                  "sign_flip", "zero_duty", "scale",
                                  "drops", "hostile"])
def test_compiled_channel_matches_jax_exactly(name, seed):
    jg, tg = j_ring(N), ring_graph(N)
    js = _channels(J_MOD, jg.edges)[name].apply(
        j_make_schedule(jg, 15, comms_per_grad=1.5, seed=seed), seed=seed)
    ts = _channels(T_MOD, tg.edges)[name].apply(
        make_schedule(tg, 15, comms_per_grad=1.5, seed=seed), seed=seed)
    np.testing.assert_array_equal(ts.partners, js.partners)
    np.testing.assert_array_equal(ts.event_mask, js.event_mask)
    assert sorted(ts.extras_dict()) == sorted(js.extras_dict())
    for k, a in js.extras_dict().items():
        assert ts.extras[k].dtype == a.dtype, k
        np.testing.assert_array_equal(ts.extras[k], a, err_msg=k)
    np.testing.assert_array_equal(degradation_profile(ts),
                                  j_degradation(js))
    assert has_channel_extras(ts) == (STALE_KEY in ts.extras_dict()
                                      or CORRUPT_KEY in ts.extras_dict())


def test_trivial_channel_is_the_same_schedule():
    g = ring_graph(8)
    sched = make_schedule(g, 6, seed=1)
    for chan in (ChannelModel(), ChannelModel(delay=DelayProcess(0)),
                 ChannelModel(delay=DelayProcess(3, prob=0.0))):
        assert chan.is_trivial and chan.horizon == 0
        assert chan.apply(sched, seed=4) is sched
    # drops only erase pairs, and the drop marker is host-only data
    dropped = ChannelModel(drop_prob=0.5).apply(sched, seed=0)
    assert DROP_KEY in dropped.extras and not has_channel_extras(dropped)
    assert ((dropped.partners == np.arange(8))
            | (dropped.partners == sched.partners)).all()


def test_channel_json_round_trip_and_validation():
    g = ring_graph(8)
    chans = list(_channels(T_MOD, g.edges).values())
    jchans = list(_channels(J_MOD, j_ring(8).edges).values())
    for chan, jchan in zip(chans, jchans):
        assert ChannelModel.from_dict(chan.to_dict()) == chan
        assert chan.to_dict() == jchan.to_dict()
    with pytest.raises(ValueError, match=r"DelayProcess\.horizon"):
        DelayProcess(horizon=-1)
    with pytest.raises(ValueError, match=r"ByzantineEdges\.mode"):
        ByzantineEdges(((0, 1),), mode="gaslight")
    with pytest.raises(ValueError, match=r"channel\.drop_prob"):
        ChannelModel(drop_prob=1.0)
    with pytest.raises(ValueError, match=r"outside \[0, 8\)"):
        ChannelModel(adversary=ByzantineEdges(((0, 99),))).validate_for(8)


def test_with_extras_shapes():
    sched = make_schedule(ring_graph(6), 4, seed=0)
    R, K, n = sched.partners.shape
    out = sched.with_extras(tag=np.ones((R, K), np.float32))
    assert out.extras["tag"].shape == (R, K, n)
    assert sched.extras is None          # the original is left alone
    with pytest.raises(ValueError, match="extras"):
        sched.with_extras(tag=np.ones((R, n)))


def test_ring_matches_jax_and_owns_its_storage():
    rng = np.random.default_rng(3)
    w, d, h = 6, 128, 3
    snaps = rng.normal(size=(h, w, d)).astype(np.float32)
    buf = rng.normal(size=(w, d)).astype(np.float32)
    partner = np.array([1, 0, 2, 4, 3, 5], np.int32)
    src = np.array([0, 2, 3, 3, 1, 3], np.int32)     # 3 = fresh sentinel
    ring = ring_init(torch.zeros(w, d), h)
    for pos in range(h):
        ring_push(ring, torch.from_numpy(snaps[pos]), pos)
    got = ring_read(ring, torch.from_numpy(buf), torch.from_numpy(partner),
                    torch.from_numpy(src))
    want = j_ring_read(jnp.asarray(snaps), jnp.asarray(buf),
                       jnp.asarray(partner), jnp.asarray(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every slot is its own storage, and a push copies: writing one slot,
    # or the pushed buffer afterwards, leaves the other slots as they were
    src_buf = torch.ones(w, d)
    ring_push(ring, src_buf, 1)
    src_buf.fill_(7.0)
    assert torch.equal(ring[1], torch.ones(w, d))
    np.testing.assert_array_equal(ring[0].numpy(), snaps[0])
    np.testing.assert_array_equal(ring[2].numpy(), snaps[2])
    with pytest.raises(ValueError):
        ring_init(torch.zeros(w, d), 0)


# ------------------------------------------------------------ the kernel

def _kernel_inputs(w, d, seed, d_real=None):
    """Mixed rows: honest pairs (corrupt 0), a 1e3 scale row, a sign-flip
    row, a zero row, an mscale-0 row, a norm-clipped row, idle rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(w, d)).astype(np.float32)
    xt = rng.normal(size=(w, d)).astype(np.float32)
    if d_real is not None:
        x[:, d_real:] = 0
        xt[:, d_real:] = 0
    partner = np.arange(w)
    partner[:w - 2] = np.arange(w - 2).reshape(-1, 2)[:, ::-1].reshape(-1)
    xp = x[partner]                          # the last two rows are idle
    corrupt = np.zeros(w, np.float32)
    corrupt[1], corrupt[2], corrupt[3] = 999.0, -2.0, -1.0
    mscale = np.ones(w, np.float32)
    mscale[4], mscale[5] = 0.0, 0.3
    dt = rng.uniform(0.0, 1.5, size=w).astype(np.float32)
    return x, xt, xp, corrupt, mscale, dt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 2.5])
@pytest.mark.parametrize("want_rej", [False, True])
def test_ref_matches_jax_kernel_and_oracle(dtype, clip, want_rej):
    x, xt, xp, corrupt, mscale, dt = _kernel_inputs(8, 384, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(clip=clip, want_rej=want_rej, **ACID)
    tout = channel_gossip_stacked_ref(
        torch.from_numpy(x).to(tdt), torch.from_numpy(xt).to(tdt),
        torch.from_numpy(xp).to(tdt), torch.from_numpy(corrupt),
        torch.from_numpy(mscale), torch.from_numpy(dt), **kw)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(xt, jdt), jnp.asarray(xp, jdt),
             jnp.asarray(corrupt), jnp.asarray(mscale), jnp.asarray(dt))
    for jout in (j_ref(*jargs, **kw), j_kernel(*jargs, interpret=True, **kw)):
        assert len(jout) == len(tout) == (3 if want_rej else 2)
        for j, t in zip(jout, tout):
            if dtype == "bfloat16":
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(j, np.float32))
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(j, np.float32),
                                           **TOL_F32)
        if want_rej:   # the mask is exact
            np.testing.assert_array_equal(tout[2].numpy(),
                                          (mscale == 0).astype(np.float32))



def test_bf16_per_event_steps_match_jax_bitwise():
    """The per-event p2p update (alpha, alpha~) and the gradient step
    (gamma) on a bf16 pytree equal the JAX package's bit for bit."""
    rng = np.random.default_rng(8)
    tree = {k: rng.normal(size=(8,) + shape).astype(np.float32)
            for k, shape in (("w", (4, 32)), ("b", (32,)))}
    tree_t = {k: rng.normal(size=a.shape).astype(np.float32)
              for k, a in tree.items()}
    grads = {k: rng.normal(size=a.shape).astype(np.float32)
             for k, a in tree.items()}
    partner = np.array([1, 0, 3, 2, 5, 4, 6, 7], np.int32)
    dyn = dict(eta=0.37, alpha=0.5, alpha_tilde=1.37, chi=1.0)

    def bf16(t, mod):
        if mod == "t":
            return {k: torch.from_numpy(a).to(torch.bfloat16)
                    for k, a in t.items()}
        return {k: jnp.asarray(a, jnp.bfloat16) for k, a in t.items()}

    outs_t = matched_p2p_update(bf16(tree, "t"), bf16(tree_t, "t"),
                                torch.from_numpy(partner),
                                A2CiD2Params(**dyn))
    outs_t += gradient_event(bf16(tree, "t"), bf16(tree_t, "t"),
                             bf16(grads, "t"), 0.05)
    outs_j = j_matched_p2p(bf16(tree, "j"), bf16(tree_t, "j"),
                           jnp.asarray(partner), JParams(**dyn))
    outs_j += j_gradient_event(bf16(tree, "j"), bf16(tree_t, "j"),
                               bf16(grads, "j"), 0.05)
    for t, j in zip(outs_t, outs_j):
        for k in tree:
            np.testing.assert_array_equal(t[k].float().numpy(),
                                          np.asarray(j[k], np.float32),
                                          err_msg=k)


def test_ref_clip_propagates_nan_like_jax():
    x, xt, xp, corrupt, mscale, dt = _kernel_inputs(8, 128, seed=2)
    xp[4, :5] = np.inf                      # inf * mscale 0 -> NaN in m
    kw = dict(clip=2.5, **ACID)
    tx, txt = channel_gossip_stacked_ref(
        *(torch.from_numpy(a) for a in (x, xt, xp, corrupt, mscale, dt)),
        **kw)
    jx, jxt = j_ref(*(jnp.asarray(a) for a in (x, xt, xp, corrupt, mscale,
                                               dt)), **kw)
    assert torch.isnan(tx[4, :5]).all() and np.isnan(np.asarray(jx)[4, :5]
                                                     ).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL_F32)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jxt), **TOL_F32)


def test_ref_exact_reductions():
    """corrupt 0, mscale 1, no clip: bitwise the clean batch; an mscale-0
    row with eta 0 is untouched; padding stays 0."""
    x, xt, xp, corrupt, mscale, dt = _kernel_inputs(8, 256, seed=3,
                                                    d_real=200)
    tx, txt, txp, tc, tm, tdt = (torch.from_numpy(a) for a in
                                 (x, xt, xp, corrupt, mscale, dt))
    partner = torch.tensor([1, 0, 3, 2, 5, 4, 6, 7], dtype=torch.int32)
    clean = mixing_gossip_stacked_ref(tx, txt, partner, tdt, **ACID)
    chan = channel_gossip_stacked_ref(tx, txt, tx[partner.long()],
                                      torch.zeros(8), torch.ones(8), tdt,
                                      **ACID)
    for a, b in zip(clean, chan):
        assert torch.equal(a, b)
    ox, oxt = channel_gossip_stacked_ref(tx, txt, txp, tc, tm, tdt, eta=0.0,
                                         alpha=0.5, alpha_t=0.5)
    assert torch.equal(ox[4], tx[4]) and torch.equal(oxt[4], txt[4])
    assert (ox[:, 200:] == 0).all() and (oxt[:, 200:] == 0).all()


# ------------------------------------------------------------ the replay

def j_grad_fn(x, key, worker_id):
    b = jnp.asarray(B)[worker_id]
    return 0.5 * jnp.sum((x - b) ** 2), x - b


def t_grad_fn(x, generator, worker_ids):
    b = torch.from_numpy(B).to(x.device)[worker_ids]
    return 0.5 * ((x - b) ** 2).sum(dim=1), x - b


def _hostile(mod, edges):
    Chan, Delay, Byz = mod
    return Chan(delay=Delay(horizon=3, prob=0.6),
                adversary=Byz(edges[:2], "sign_flip"), drop_prob=0.1)


def _port_sim(**kw):
    return Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                     device="cpu", **kw)


def _port_state(sim):
    return sim.init(torch.zeros(DIM), N, torch.Generator().manual_seed(0))


# thresholds inside the norm range of this workload (honest deltas 0.05-1.0,
# sign-flipped ones 0.03-1.1), so every rule rejects, rescales or clips
ROBUST = {"plain": {}, "trim": dict(robust_clip=0.5),
          "clip": dict(robust_clip=0.5, robust_rule="clip"),
          "coord": dict(robust_clip=0.1, robust_rule="coord")}


@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("rule", list(ROBUST))
def test_port_matches_jax_channel_replay(rule, engine):
    seed = 2
    jg, tg = j_ring(N), ring_graph(N)
    jsched = _hostile(J_MOD, jg.edges).apply(
        j_make_schedule(jg, ROUNDS, comms_per_grad=1.5, seed=seed), seed=seed)
    tsched = _hostile(T_MOD, tg.edges).apply(
        make_schedule(tg, ROUNDS, comms_per_grad=1.5, seed=seed), seed=seed)
    jsim = JSim(j_grad_fn, j_params(jg), GAMMA, backend="ref", **ROBUST[rule])
    jf, jt = jsim.run_schedule(
        jsim.init(jnp.zeros(DIM), N, jax.random.PRNGKey(0)), jsched,
        engine=engine)
    sim = _port_sim(**ROBUST[rule])
    tf, tt = sim.run_schedule(_port_state(sim), tsched, engine=engine)
    assert tt.defense is None and jt.defense is None
    for name in ("loss", "consensus", "mean_param_norm"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **TOL)
    np.testing.assert_allclose(tf.x_tilde.numpy(), np.asarray(jf.x_tilde),
                               **TOL)
    np.testing.assert_array_equal(tf.t_last.numpy(), np.asarray(jf.t_last))


@pytest.mark.parametrize("rule", ["plain", "trim"])
def test_engine_matches_per_event_channel_replay(rule):
    g = ring_graph(N)
    sched = _hostile(T_MOD, g.edges).apply(
        make_schedule(g, ROUNDS, comms_per_grad=2.0, seed=6), seed=6)
    sim = _port_sim(**ROBUST[rule])
    ef, et = sim.run_schedule(_port_state(sim), sched)
    rf, rt = sim.run_schedule(_port_state(sim), sched, engine=False)
    for name in ("loss", "consensus", "mean_param_norm"):
        torch.testing.assert_close(getattr(et, name), getattr(rt, name),
                                   **TOL)
    torch.testing.assert_close(ef.x, rf.x, **TOL)
    torch.testing.assert_close(ef.x_tilde, rf.x_tilde, **TOL)


@pytest.mark.parametrize("engine", [True, False])
def test_zero_corrupt_and_horizon0_replay_bitwise_clean(engine):
    g = ring_graph(N)
    sched = make_schedule(g, ROUNDS, comms_per_grad=1.5, seed=9)
    zeros = np.zeros_like(sched.partners)
    sim = _port_sim()
    clean = sim.run_schedule(_port_state(sim), sched, engine=engine)
    for extras in ({CORRUPT_KEY: zeros.astype(np.float32)},
                   {STALE_KEY: zeros.astype(np.int32)}):
        chan = sim.run_schedule(_port_state(sim),
                                dataclasses.replace(sched, extras=extras),
                                engine=engine)
        for a, b in ((clean[0].x, chan[0].x),
                     (clean[0].x_tilde, chan[0].x_tilde),
                     (clean[1].consensus, chan[1].consensus),
                     (clean[1].loss, chan[1].loss)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ on a card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,tol", [(torch.float32, 16512, 1e-5),
                                         (torch.bfloat16, 4096, 0.0)])
@pytest.mark.parametrize("clip", [None, 2.5])
def test_cuda_channel_kernel_matches_ref(dtype, d, tol, clip):
    _cuda_or_skip()
    x, xt, xp, corrupt, mscale, dt = _kernel_inputs(8, d, seed=5,
                                                    d_real=d - 100)
    tx, txt, txp = (torch.from_numpy(a).cuda().to(dtype) for a in (x, xt,
                                                                   xp))
    tc, tm, tdt = (torch.from_numpy(a).cuda() for a in (corrupt, mscale,
                                                        dt))
    kw = dict(clip=clip, want_rej=True, **ACID)
    rx, rxt, rrej = channel_event_stacked(tx, txt, txp, tc, tm, tdt,
                                          backend="ref", **kw)
    kxt_in = txt.clone()
    before = t_kernel.channel_gossip_stacked.launches
    kx, kxt, krej = channel_event_stacked(tx, kxt_in, txp, tc, tm, tdt, **kw)
    torch.cuda.synchronize()
    assert t_kernel.channel_gossip_stacked.launches == before + 1
    assert kxt.data_ptr() == kxt_in.data_ptr()  # x~ updated in place
    torch.testing.assert_close(kx.float(), rx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(kxt.float(), rxt.float(), rtol=tol, atol=tol)
    assert torch.equal(krej, rrej)
    assert torch.equal(krej.cpu(), torch.from_numpy(mscale == 0).float())
    assert (kx[:, d - 100:] == 0).all() and (kxt[:, d - 100:] == 0).all()


@pytest.mark.gpu
def test_cuda_channel_kernel_degenerates_to_clean_kernel():
    _cuda_or_skip()
    x, xt, _, _, _, dt = _kernel_inputs(8, 16512, seed=6)
    tx, txt, tdt = (torch.from_numpy(a).cuda() for a in (x, xt, dt))
    partner = torch.tensor([1, 0, 3, 2, 5, 4, 6, 7], dtype=torch.int32,
                           device="cuda")
    cx, cxt = t_kernel.mixing_gossip_stacked(tx, txt.clone(), partner, tdt,
                                             **ACID)
    kx, kxt = t_kernel.channel_gossip_stacked(
        tx, txt.clone(), tx[partner.long()].contiguous(),
        torch.zeros(8, device="cuda"), torch.ones(8, device="cuda"), tdt,
        **ACID)
    assert torch.equal(cx, kx) and torch.equal(cxt, kxt)
    # a rejected row (mscale 0) with eta 0 is untouched
    ms = torch.ones(8, device="cuda")
    ms[2] = 0.0
    ox, oxt = t_kernel.channel_gossip_stacked(
        tx, txt.clone(), tx[partner.long()].contiguous(),
        torch.zeros(8, device="cuda"), ms, tdt, eta=0.0, alpha=0.5,
        alpha_t=0.5)
    assert torch.equal(ox[2], tx[2]) and torch.equal(oxt[2], txt[2])
