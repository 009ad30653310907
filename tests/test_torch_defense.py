"""Port parity for the self-healing defense.

  * the host half (``AdaptiveDefense`` validation, JSON, the comm
    controller) gives exactly the JAX package's results;
  * the device functions (``defense_comm``/``absorb``/``grad``) give the
    JAX package's outputs on the same inputs, counts and masks exactly;
  * ``run_schedule(defense=AdaptiveDefense())`` matches the JAX package on
    a scale-1e3 and a sign-flip attack, engine and per-event path:
    rejection and quarantine counts exactly, tau and the metrics at rtol
    1e-5 (atol 1e-6);
  * neutral knobs are bitwise the static-trim path, and an active defense
    demands the trim rule.
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
from repro.core import make_schedule as j_make_schedule
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro.core import defense as jdef
from repro_torch.core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                              DefenseTrace, DelayProcess, Simulator,
                              make_schedule, params_from_graph, ring_graph)
from repro_torch.core import defense as tdef

N, DIM, ROUNDS, GAMMA = 16, 16, 30, 0.05
B = np.random.default_rng(11).normal(size=(N, DIM)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
SPECS = [AdaptiveDefense(),
         AdaptiveDefense(tau0=2.5, q=4.0, quantile=0.75, beta=0.1),
         AdaptiveDefense(adaptive_tau=False, trust=True, rho=0.5),
         AdaptiveDefense(comm_lo=0.5, comm_hi=2.0, comm_degrade=1.0)]


def _jdef(spec):
    return JDefense(**dataclasses.asdict(spec))


def test_defense_spec_json_and_validation():
    for spec in SPECS:
        assert AdaptiveDefense.from_json(spec.to_json()) == spec
        assert spec.to_dict() == _jdef(spec).to_dict()
        assert spec.is_active == _jdef(spec).is_active
    assert AdaptiveDefense().to_dict()["tau0"] is None
    for kw in ({"q": 0.0}, {"quantile": 1.5}, {"beta": 0.0},
               {"tau0": -1.0}, {"rho": 2.0}, {"trust_floor": 1.0},
               {"heal": -0.1}, {"comm_lo": 0.9, "comm_hi": 0.5},
               {"comm_degrade": -1.0}):
        with pytest.raises(ValueError):
            AdaptiveDefense(**kw)


def test_comm_control_matches_jax():
    tg, jg = ring_graph(8), j_ring(8)
    ctl = AdaptiveDefense(adaptive_tau=False, trust=False, comm_lo=0.5,
                          comm_hi=2.0, comm_degrade=0.5)
    chan = ChannelModel(delay=DelayProcess(horizon=2, prob=0.5))
    jchan = JChannel(delay=JDelay(horizon=2, prob=0.5))
    ts = ctl.apply_comm_control(
        chan.apply(make_schedule(tg, 20, comms_per_grad=2.0, seed=3), 3))
    js = _jdef(ctl).apply_comm_control(
        jchan.apply(j_make_schedule(jg, 20, comms_per_grad=2.0, seed=3), 3))
    np.testing.assert_array_equal(ts.partners, js.partners)
    np.testing.assert_array_equal(ts.event_mask, js.event_mask)
    for k in js.extras_dict():
        np.testing.assert_array_equal(ts.extras[k], js.extras[k])
    assert (ts.partners != np.arange(8)).sum() < (
        make_schedule(tg, 20, comms_per_grad=2.0, seed=3).partners
        != np.arange(8)).sum()
    sched = make_schedule(tg, 5, seed=0)
    assert AdaptiveDefense().apply_comm_control(sched) is sched


@pytest.mark.parametrize("spec", [None, AdaptiveDefense(),
                                  AdaptiveDefense(adaptive_tau=False)])
def test_device_functions_match_jax(spec):
    """Three comm steps then a gradient tick, from a state with part of the
    trust already damaged, on both packages' functions."""
    rng = np.random.default_rng(4)
    n = 8
    tk = tdef.knobs_single(spec, 2.0, "cpu")
    jk = jdef.knobs_single(None if spec is None else _jdef(spec), 2.0)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    trust = rng.uniform(0.0, 1.0, size=(n, n)).astype(np.float32)
    ts = tdef.defense_init(n, "cpu")._replace(trust=torch.from_numpy(trust),
                                       qest=torch.tensor(0.4))
    js = jdef.defense_init(n)._replace(trust=jnp.asarray(trust),
                                       qest=jnp.float32(0.4))
    for step in range(3):
        partner = np.arange(n, dtype=np.int32)
        perm = rng.permutation(n)
        for i, j in perm[:6].reshape(3, 2):
            partner[i], partner[j] = j, i
        involved = partner != np.arange(n)
        nrm = np.where(involved, rng.uniform(0.0, 8.0, size=n),
                       0.0).astype(np.float32)
        tm, tq, ts = tdef.defense_comm(tk, ts, torch.from_numpy(partner),
                                       torch.from_numpy(involved),
                                       torch.from_numpy(nrm))
        jm, jq, js = jdef.defense_comm(jk, js, jnp.asarray(partner),
                                       jnp.asarray(involved),
                                       jnp.asarray(nrm))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        rej = (tm == 0).float()
        ts = tdef.defense_absorb(ts, rej, tq, torch.from_numpy(involved))
        js = jdef.defense_absorb(js, jnp.asarray(rej.numpy()), jq,
                                 jnp.asarray(involved))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ts, trow = tdef.defense_grad(tk, ts)
    js, jrow = jdef.defense_grad(jk, js)
    for a, b in zip(trow, jrow):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------ the replay

def j_grad_fn(x, key, worker_id):
    b = jnp.asarray(B)[worker_id]
    return 0.5 * jnp.sum((x - b) ** 2), x - b


def t_grad_fn(x, generator, worker_ids):
    b = torch.from_numpy(B).to(x.device)[worker_ids]
    return 0.5 * ((x - b) ** 2).sum(dim=1), x - b


def _attack(byz_cls, chan_cls, g, mode, scale, prob):
    """A Byzantine fraction of 1/8 of the ring's edges, as the JAX
    package's defense tests pick them (evenly spaced)."""
    picks = np.linspace(0, len(g.edges), 2, endpoint=False).astype(int)
    return chan_cls(adversary=byz_cls(tuple(g.edges[i] for i in picks),
                                      mode, scale=scale, prob=prob))


ATTACKS = {"scale": ("scale", 1e3, 0.5), "sign_flip": ("sign_flip", 1.0,
                                                       1.0)}


def _both(attack, seed=0):
    jg, tg = j_ring(N), ring_graph(N)
    mode, scale, prob = ATTACKS[attack]
    js = _attack(JByz, JChannel, jg, mode, scale, prob).apply(
        j_make_schedule(jg, ROUNDS, seed=seed), seed=seed)
    ts = _attack(ByzantineEdges, ChannelModel, tg, mode, scale, prob).apply(
        make_schedule(tg, ROUNDS, seed=seed), seed=seed)
    return js, ts


def _port(sched, engine, clip=5.0, defense=None, **kw):
    sim = Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                    robust_clip=clip, device="cpu", **kw)
    st = sim.init(torch.zeros(DIM), N, torch.Generator().manual_seed(0))
    return sim.run_schedule(st, sched, engine=engine, defense=defense)


@pytest.mark.parametrize("engine", [True, False])
@pytest.mark.parametrize("attack", list(ATTACKS))
def test_defense_replay_matches_jax(attack, engine):
    js, ts = _both(attack)
    jsim = JSim(j_grad_fn, j_params(j_ring(N)), GAMMA, backend="ref",
                robust_clip=5.0)
    jf, jt = jsim.run_schedule(
        jsim.init(jnp.zeros(DIM), N, jax.random.PRNGKey(0)), js,
        engine=engine, defense=JDefense())
    tf, tt = _port(ts, engine, defense=AdaptiveDefense())
    assert isinstance(tt.defense, DefenseTrace)
    # the loop really acted on this attack
    assert float(np.asarray(jt.defense.rejections).sum()
                 + np.asarray(jt.defense.quarantined).sum()) > 0
    np.testing.assert_array_equal(tt.defense.rejections.numpy(),
                                  np.asarray(jt.defense.rejections))
    np.testing.assert_array_equal(tt.defense.quarantined.numpy(),
                                  np.asarray(jt.defense.quarantined))
    np.testing.assert_allclose(tt.defense.tau.numpy(),
                               np.asarray(jt.defense.tau), **TOL)
    for name in ("loss", "consensus", "mean_param_norm"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **TOL)
    np.testing.assert_allclose(tf.x_tilde.numpy(), np.asarray(jf.x_tilde),
                               **TOL)


def test_defense_engine_matches_per_event():
    _, ts = _both("scale", seed=3)
    ef, et = _port(ts, True, defense=AdaptiveDefense())
    rf, rt = _port(ts, False, defense=AdaptiveDefense())
    assert torch.equal(et.defense.rejections, rt.defense.rejections)
    assert torch.equal(et.defense.quarantined, rt.defense.quarantined)
    torch.testing.assert_close(et.defense.tau, rt.defense.tau, **TOL)
    torch.testing.assert_close(et.consensus, rt.consensus, **TOL)
    torch.testing.assert_close(ef.x, rf.x, **TOL)


@pytest.mark.parametrize("engine", [True, False])
def test_neutral_knobs_are_bitwise_static_trim(engine):
    _, ts = _both("scale")
    sim = Simulator(t_grad_fn, params_from_graph(ring_graph(N)), GAMMA,
                    robust_clip=5.0, device="cpu")
    st = sim.init(torch.zeros(DIM), N, torch.Generator().manual_seed(0))
    static_f, static_t = sim.run_schedule(st, ts, engine=engine)
    knobs = tdef.knobs_single(None, 5.0, "cpu")
    if engine:
        arrays, h = sim.channel_coalesced_arrays(st, ts)
        neutral_f, neutral_t = sim.run_channel_coalesced(st, arrays, h,
                                                         knobs)
    else:
        arrays, h = sim.channel_reference_arrays(ts)
        neutral_f, neutral_t = sim.run_channel(st, arrays, h, knobs)
    assert static_t.defense is None
    assert torch.equal(static_f.x, neutral_f.x)
    assert torch.equal(static_f.x_tilde, neutral_f.x_tilde)
    assert torch.equal(static_t.consensus, neutral_t.consensus)
    # the neutral loop never quarantines and counts the static rejections
    assert neutral_t.defense.quarantined.sum() == 0
    assert (neutral_t.defense.tau == 5.0).all()


def test_active_defense_requires_trim_rule():
    _, ts = _both("scale")
    with pytest.raises(ValueError, match="trim"):
        _port(ts, True, defense=AdaptiveDefense(), robust_rule="clip")
    with pytest.raises(ValueError, match="trim"):
        _port(ts, False, defense=AdaptiveDefense(), robust_rule="coord")
    # a defense whose loops are both off is only a schedule transform: the
    # replay runs the static path and attaches no trace
    _, tr = _port(ts, True, defense=AdaptiveDefense(adaptive_tau=False,
                                                    trust=False),
                  robust_rule="clip")
    assert tr.defense is None
