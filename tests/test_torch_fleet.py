"""Port parity for the gossip-serving fleet (``launch/fleet.py``, DESIGN.md
§14): the fleet's gossip side IS the simulator's per-event channel replay
(the final bank and the consensus trace bit for bit
``run_schedule(engine=False)``), a churn kill degrades but loses nothing, a
gossip-off or stalled fleet serves exactly ``generate``'s ids, a dead fleet
reports its loss without a drain spin, the TTFT breakdown with the port's
``SpanTracer`` / ``MetricsRegistry``, and a JAX-against-port fleet on
``train_bench()`` with a noise-free drift given to both packages.

Tolerances: the JAX-against-port bank within rtol 1e-6 plus 1e-6 of its
largest magnitude (f32 mixing, p2p and drift steps summed in another order
by XLA and PyTorch over 14 rounds); request prompts, counts, latencies and
TTFT exactly.  Within the port everything is compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nano_lm import train_bench as j_train_bench
from repro.core import Algorithm as JAlgorithm
from repro.core import ChannelModel as JChannelModel
from repro.core import DelayProcess as JDelayProcess
from repro.core import PhaseSwitch as JPhaseSwitch
from repro.core import ServeLoad as JServeLoad
from repro.core import World as JWorld
from repro.core import ring_graph as j_ring
from repro.launch.fleet import GossipFleet as JGossipFleet
from repro.models import Model as JModel
from repro_torch.analysis import (MetricsRegistry, SpanTracer,
                                  parse_exposition, validate_trace)
from repro_torch.configs.nano_lm import train_bench
from repro_torch.convert import params_from_jax
from repro_torch.core import (Algorithm, ChannelModel, DelayProcess,
                              PhaseSwitch, ServeLoad, World, ring_graph)
from repro_torch.core.simulator import SimState
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.fleet import (GossipFleet, _perturb_grad,
                                      make_fleet_step)
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import Model

LOAD = ServeLoad(rate=0.8, prompt_len=(2, 4), gen_len=(2, 5))
BANK_RTOL = 1e-6


def _model_params(seed=0):
    model = Model(train_bench())
    return model, model.init(torch.Generator().manual_seed(seed))


def _generate_ids(model, params, q):
    ref = generate(model, params, torch.from_numpy(q.prompt)[None].long(),
                   q.max_new)
    return ref[0, len(q.prompt):].tolist()


def test_fleet_bank_is_the_channel_replay_bitwise():
    """Round-by-round fleet gossip == one ``run_schedule(engine=False)`` on
    the same lossy schedule: the same final (W, D) bank and consensus
    trace, bit for bit; the fleet's start bank untouched."""
    model, params = _model_params()
    world = World(topology=ring_graph(4), algorithm=Algorithm("a2cid2"),
                  channel=ChannelModel(delay=DelayProcess(horizon=2,
                                                          prob=0.4),
                                       drop_prob=0.1),
                  serve=LOAD)
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="perturb", drift_scale=0.02)
    bank0 = fleet._bank0.clone()
    rep = fleet.run(rounds=12, seed=3)
    assert torch.equal(fleet._bank0, bank0)

    sched = world.compile(12, seed=3)
    state = SimState(fleet._bank0, fleet._bank0.clone(), torch.zeros(4),
                     torch.Generator().manual_seed(3))
    out, trace = fleet.sim.run_schedule(state, sched, engine=False)
    assert torch.equal(rep.final_bank, out.x)
    assert not torch.equal(rep.final_bank, bank0)   # the drift happened
    assert rep.consensus.dtype == np.float64
    assert rep.consensus.size == rep.rounds + rep.drain_rounds
    np.testing.assert_array_equal(rep.consensus[:rep.rounds],
                                  trace.consensus.numpy().astype(np.float64))
    if rep.drain_rounds:
        tail = rep.consensus[rep.rounds:]
        assert np.all(tail == tail[0])


def test_churn_kill_readmits_without_loss():
    model, params = _model_params()
    world = World(topology=ring_graph(3),
                  faults=(PhaseSwitch(6, active=(True, True, False)),),
                  serve=ServeLoad(rate=1.5, prompt_len=(3, 5),
                                  gen_len=(4, 8), arrive_frac=0.8))
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="perturb", drift_scale=0.02)
    rep = fleet.run(rounds=14, seed=0)
    assert rep.requests_total > 0
    assert rep.lost == 0
    assert len(rep.completed) == rep.requests_total
    assert rep.restarted >= 1  # the kill caught work in flight
    assert all(q.done and len(q.out) == q.max_new for q in rep.completed)


@pytest.mark.parametrize("stall", [0.0, 1.0])
def test_gossip_off_and_stalled_fleets_match_sequential_generate(stall):
    """comms_per_grad=0 (or a stall of one decode round an event with
    gossip on) and drift='none': the bank stays bit for bit its start, and
    every request's ids are bit for bit the single-model ``generate``
    ones, the in-flight caches of a stalled replica intact."""
    model, params = _model_params()
    world = World(topology=ring_graph(3), algorithm=Algorithm("adpsgd"),
                  comms_per_grad=1.0 if stall else 0.0, serve=LOAD)
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="none", stall_per_event=stall)
    rep = fleet.run(rounds=12, seed=1)
    if stall:
        assert rep.stall_skips > 0   # stalls happened mid-serve
    assert torch.equal(rep.final_bank, fleet._bank0)
    assert rep.lost == 0 and rep.requests_total > 0
    for q in rep.completed:
        assert q.out == _generate_ids(model, params, q), q.uid


def test_whole_fleet_dead_reports_loss_without_drain_spin():
    model, params = _model_params()
    world = World(topology=ring_graph(2),
                  faults=(PhaseSwitch(2, active=(False, False)),),
                  serve=ServeLoad(rate=1.0, prompt_len=(2, 3),
                                  gen_len=(2, 3)))
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="none")
    rep = fleet.run(rounds=8, seed=0)
    assert rep.requests_total > 0
    assert rep.lost > 0           # honest accounting, not a silent hang
    assert rep.drain_rounds == 0  # no no-op spin


def test_fleet_ttft_breakdown_sums_and_bounds():
    """TTFT splits exactly into admission wait + decode, never exceeds the
    latency; the port's tracer and registry give a schema-valid trace and
    a parseable exposition whose counters match the report."""
    model, params = _model_params()
    world = World(topology=ring_graph(3), algorithm=Algorithm("adpsgd"),
                  serve=ServeLoad(rate=1.2, prompt_len=(2, 4),
                                  gen_len=(2, 5)))
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="perturb", drift_scale=0.02)
    tracer = SpanTracer("fleet-test")
    registry = MetricsRegistry()
    rep = fleet.run(rounds=12, seed=2, tracer=tracer, metrics=registry)

    assert rep.ttft.size == len(rep.completed) > 0
    np.testing.assert_array_equal(rep.ttft_wait + rep.ttft_decode, rep.ttft)
    assert np.all(rep.ttft >= 1)
    assert np.all(rep.ttft <= rep.latencies)
    s = rep.summary()
    assert s["ttft_p50"] <= s["ttft_p95"] <= s["ttft_p99"]
    assert s["ttft_wait_mean"] + s["ttft_decode_mean"] == \
        pytest.approx(s["ttft_mean"])

    validate_trace(tracer.to_dict())
    names = {e["name"] for e in tracer.events}
    assert {"fleet.round", "fleet.decode", "fleet.drain"} <= names
    parsed = parse_exposition(registry.exposition())
    assert parsed["fleet_requests_total"][""] == rep.requests_total
    assert parsed["fleet_ttft_rounds_count"][""] == len(rep.completed)
    assert parsed["fleet_tokens_total"][""] == rep.tokens_generated


def test_fleet_refuses_bad_arguments():
    model, params = _model_params()
    with pytest.raises(ValueError, match="ServeLoad"):
        GossipFleet(model, params, World(ring_graph(3)))
    world = World(ring_graph(3), serve=LOAD)
    with pytest.raises(ValueError, match="max_len"):
        GossipFleet(model, params, world, max_len=8)
    with pytest.raises(ValueError, match="drift"):
        GossipFleet(model, params, world, drift="walk")


def test_fleet_step_is_each_replicas_batched_step():
    """The vmapped step over a (W, D) bank of distinct replicas equals each
    replica's own step (its params unpacked, its caches), bit for bit in
    the ids and within 1e-5 in the caches (a bmm where the replica alone
    runs a mm)."""
    from repro_torch.launch.batching import make_batched_step
    model, params = _model_params()
    world = World(ring_graph(3), serve=LOAD)
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=10)
    bank = fleet._bank0 + 0.05 * _perturb_grad(
        fleet._bank0, torch.Generator().manual_seed(0), None)[1]
    step = make_fleet_step(model, fleet.layout)
    caches = tree_map(lambda a: a.unsqueeze(0).repeat(
        (3,) + (1,) * a.dim()), fleet._caches0)
    toks = torch.tensor([[[3], [7]], [[1], [0]], [[5], [5]]],
                        dtype=torch.int32)
    pos = torch.zeros((3, 2), dtype=torch.int32)
    act = torch.tensor([[True, True], [True, False], [False, False]])
    nxt, new = step(bank, caches, toks, pos, act)
    one = make_batched_step(model)
    for w in range(3):
        p = fleet.layout.unpack_local(bank[w])
        c = tree_map(lambda a, w=w: a[w], caches)
        n_w, c_w = one(p, c, toks[w], pos[w], act[w])
        assert torch.equal(nxt[w], n_w)
        for a, b in zip(tree_leaves(tree_map(lambda a, w=w: a[w], new)),
                        tree_leaves(c_w)):
            assert (a.double() - b.double()).abs().max() <= \
                1e-5 * b.abs().max().double()


# ------------------------------------------------ JAX against the port

def _j_drift(p, key, wid):
    """Noise-free drift, per replica (the JAX Simulator signature)."""
    g = jax.tree.map(lambda a: 0.1 * a + 0.01 * (wid + 1), p)
    return sum(jnp.sum(a ** 2) for a in jax.tree.leaves(p)), g


def _t_drift(x, generator, ids):
    """The same drift, batched over replicas (the port's signature)."""
    def g(a):
        c = (0.01 * (ids + 1)).reshape((-1,) + (1,) * (a.dim() - 1))
        return 0.1 * a + c.to(a.dtype)
    losses = sum((a ** 2).reshape(a.shape[0], -1).sum(1)
                 for a in tree_leaves(x))
    return losses, tree_map(g, x)


SERVE_BENCH_LOAD = dict(rate=1.2, prompt_len=(3, 6), gen_len=(4, 10),
                       arrive_frac=0.55)
JAX_WORLDS = {
    "lossy": dict(topology=4, algorithm="a2cid2", faults=(),
                  channel=dict(horizon=2, prob=0.3, drop=0.1), stall=0.0,
                  load=SERVE_BENCH_LOAD),
    "churn": dict(topology=3, algorithm="a2cid2",
                  faults=((6, (True, True, False)),), channel=None,
                  stall=0.0, load=dict(rate=1.5, prompt_len=(3, 5),
                                       gen_len=(4, 8), arrive_frac=0.8)),
    "stalled": dict(topology=3, algorithm="adpsgd", faults=(),
                    channel=None, stall=0.5, load=SERVE_BENCH_LOAD),
}


def _worlds(spec):
    load = spec["load"]
    out = []
    for W, A, C, D, P, S, ring in (
            (World, Algorithm, ChannelModel, DelayProcess, PhaseSwitch,
             ServeLoad, ring_graph),
            (JWorld, JAlgorithm, JChannelModel, JDelayProcess, JPhaseSwitch,
             JServeLoad, j_ring)):
        ch = spec["channel"]
        out.append(W(topology=ring(spec["topology"]),
                      algorithm=A(spec["algorithm"]),
                      faults=tuple(P(r, active=a) for r, a in spec["faults"]),
                      channel=None if ch is None else C(
                          delay=D(horizon=ch["horizon"], prob=ch["prob"]),
                          drop_prob=ch["drop"]),
                      serve=S(**load)))
    return out


@pytest.mark.parametrize("name", sorted(JAX_WORLDS))
def test_fleet_matches_jax_with_noise_free_drift(name):
    spec = JAX_WORLDS[name]
    tworld, jworld = _worlds(spec)
    jm = JModel(j_train_bench())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(train_bench())
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    kw = dict(max_batch=2, max_len=24, drift_scale=0.05,
              stall_per_event=spec["stall"])
    jrep = JGossipFleet(jm, jp, jworld, grad_fn=_j_drift, **kw).run(
        rounds=14, seed=0)
    trep = GossipFleet(tm, tp, tworld, grad_fn=_t_drift, **kw).run(
        rounds=14, seed=0)

    want = np.asarray(jrep.final_bank)
    got = trep.final_bank.numpy()
    np.testing.assert_allclose(got, want, rtol=BANK_RTOL,
                               atol=BANK_RTOL * np.abs(want).max())
    assert not np.array_equal(want, np.asarray(
        JGossipFleet(jm, jp, jworld, **kw)._bank0))   # the drift happened
    np.testing.assert_allclose(trep.consensus, jrep.consensus,
                               rtol=1e-5, atol=1e-7)
    for f in ("requests_total", "lost", "restarted", "stall_skips",
              "drain_rounds", "rounds"):
        assert getattr(trep, f) == getattr(jrep, f), f
    for f in ("latencies", "ttft", "ttft_wait", "ttft_decode"):
        np.testing.assert_array_equal(getattr(trep, f), getattr(jrep, f))
    assert [q.uid for q in trep.completed] == [q.uid for q in jrep.completed]
    for a, b in zip(trep.completed, jrep.completed):
        np.testing.assert_array_equal(a.prompt, np.asarray(b.prompt))
        assert a.prompt.dtype == np.asarray(b.prompt).dtype
        assert (a.arrive_round, a.admit_round, a.first_token_round,
                a.done_round, a.restarts, len(a.out)) == \
            (b.arrive_round, b.admit_round, b.first_token_round,
             b.done_round, b.restarts, len(b.out))
    if name == "churn":
        assert trep.restarted >= 1 and trep.lost == 0


def test_serveload_trace_matches_jax():
    """The port's arrival trace is bit for bit JAX's (it decides when every
    request arrives and how long it is)."""
    tload = ServeLoad(rate=1.2, prompt_len=(3, 6), gen_len=(4, 10),
                      arrive_frac=0.55)
    jload = JServeLoad(rate=1.2, prompt_len=(3, 6), gen_len=(4, 10),
                       arrive_frac=0.55)
    for seed in (0, 5):
        t, j = tload.sample_trace(20, seed), jload.sample_trace(20, seed)
        for f in ("arrival_round", "prompt_len", "gen_len"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert dataclasses.asdict(tload) == dataclasses.asdict(jload)


@pytest.mark.gpu
def test_fleet_bank_on_card_is_the_channel_replay_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    model = Model(train_bench())
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    world = World(topology=ring_graph(4), algorithm=Algorithm("a2cid2"),
                  channel=ChannelModel(delay=DelayProcess(horizon=2,
                                                          prob=0.4),
                                       drop_prob=0.1),
                  serve=LOAD)
    fleet = GossipFleet(model, params, world, max_batch=2, max_len=16,
                        drift="perturb", drift_scale=0.02)
    rep = fleet.run(rounds=12, seed=3)
    assert rep.lost == 0
    state = SimState(fleet._bank0, fleet._bank0.clone(),
                     torch.zeros(4, device="cuda"),
                     torch.Generator(device="cuda").manual_seed(3))
    out, _ = fleet.sim.run_schedule(state, world.compile(12, seed=3),
                                    engine=False)
    assert torch.equal(rep.final_bank, out.x)
