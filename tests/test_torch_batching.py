"""Port parity for continuous batching: the host-only ``SlotScheduler``
(invariants under random interleavings, and step for step the JAX
package's), the ``max_len`` refusal, staggered admission equal to
sequential ``generate`` bit for bit, ``gate_caches`` keeping inactive slots
bit for bit, and the batched step against the JAX package's.

Tolerances: ids and kept cache rows exactly; the batched step's new caches
against JAX's within 1e-5 of the largest magnitude (the decode-step
tolerance of ``test_torch_decode.py``); its ids equal JAX's, or differ
only at a near-tie of JAX's logits (top-1 / top-2 margin within 1e-5 of
the largest logit magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.launch import batching as jbatching
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.batching import (ContinuousBatcher, Request,
                                         SlotScheduler, gate_caches,
                                         make_batched_step)
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import Model

STEP_TOL = NEAR_TIE = 1e-5


def _model(arch="qwen3-0.6b"):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def test_continuous_batcher_drains_mixed_requests():
    cfg, model, params = _model()
    b = ContinuousBatcher(model, params, max_batch=4, max_len=64)
    reqs = []
    for uid, (plen, gen) in enumerate([(4, 6), (8, 3), (2, 10), (5, 5),
                                       (3, 4), (6, 2)]):  # > max_batch
        r = Request(uid, _prompt(cfg, plen, uid), gen)
        reqs.append(r)
        b.submit(r)
    done = b.run_until_drained()
    assert len(done) == len(reqs)
    for r in reqs:
        assert r.done and len(r.out) == r.max_new
        assert all(0 <= t < cfg.vocab_size for t in r.out)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "nano-lm"])
def test_staggered_admission_matches_sequential_generate(arch):
    """Requests admitted mid-flight into a running batch (each slot at its
    OWN position) give the ids sequential ``generate`` gives each alone,
    bit for bit."""
    cfg, model, params = _model(arch)
    b = ContinuousBatcher(model, params, max_batch=2, max_len=32)
    reqs = [Request(uid, _prompt(cfg, plen, 10 + uid), gen)
            for uid, (plen, gen) in enumerate([(5, 6), (3, 8), (4, 5)])]
    b.submit(reqs[0])
    b.step()
    b.step()                      # req 0 is mid-prompt at pos 2...
    b.submit(reqs[1])             # ...when req 1 joins the batch
    b.submit(reqs[2])             # req 2 waits for a slot to free up
    b.run_until_drained()
    for r in reqs:
        assert r.done and len(r.out) == r.max_new
        ref = generate(model, params, torch.from_numpy(r.prompt)[None].long(),
                       r.max_new)
        assert r.out == ref[0, len(r.prompt):].tolist(), r.uid


def test_submit_rejects_request_exceeding_max_len():
    """A request that cannot finish with its full max_new inside max_len
    is refused at submit(), as the JAX scheduler refuses it."""
    s, js = SlotScheduler(2, 8), jbatching.SlotScheduler(2, 8)
    s.submit(Request(0, np.arange(3, dtype=np.int32), 4))  # 3+4+1 == 8: ok
    with pytest.raises(ValueError, match="max_len") as err:
        s.submit(Request(1, np.arange(4, dtype=np.int32), 4))  # 4+4+1 > 8
    with pytest.raises(ValueError, match="max_len") as jerr:
        js.submit(jbatching.Request(1, np.arange(4, dtype=np.int32), 4))
    assert str(err.value) == str(jerr.value)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 5), st.integers(1, 5)),
                min_size=1, max_size=12),
       st.lists(st.booleans(), max_size=40),
       st.integers(1, 4),
       st.lists(st.integers(0, 9), max_size=40))
def test_slot_scheduler_invariants(specs, interleave, max_batch, evictions):
    """Under any interleaving of submissions and steps every request
    finishes exactly once with exactly max_new ids, and the port's
    scheduler stages and absorbs step for step what JAX's does (evicting
    everything now and then and resubmitting it, as a churn kill does)."""
    ours, theirs = SlotScheduler(max_batch, 16), \
        jbatching.SlotScheduler(max_batch, 16)
    reqs = [(Request(i, np.arange(p, dtype=np.int32), g),
             jbatching.Request(i, np.arange(p, dtype=np.int32), g))
            for i, (p, g) in enumerate(specs)]
    waiting = list(reversed(reqs))
    choices, kills = iter(interleave), iter(evictions)
    for step in range(1000):
        if not waiting and not ours.pending():
            break
        assert ours.pending() == theirs.pending()
        assert ours.load() == theirs.load()
        if waiting and (next(choices, False) or not ours.pending()):
            a, b = waiting.pop()
            ours.submit(a)
            theirs.submit(b)
        elif next(kills, 1) == 0:
            back = ours.evict_all()
            jback = theirs.evict_all()
            assert [r.uid for r in back] == [r.uid for r in jback]
            for r in back:
                ours.submit(r)
            for r in jback:
                theirs.submit(r)
        else:
            staged = ours.prepare(step)
            assert staged == tuple(theirs.prepare(step))
            nxt = np.arange(max_batch, dtype=np.int32) + step
            assert [r.uid for r in ours.absorb(nxt, step)] == \
                [r.uid for r in theirs.absorb(nxt, step)]
    assert not waiting and not ours.pending()
    assert sorted(r.uid for r in ours.finished) == list(range(len(reqs)))
    for a, b in reqs:
        assert a.done and len(a.out) == a.max_new
        assert (a.out, a.done_round, a.admit_round, a.first_token_round,
                a.restarts) == (b.out, b.done_round, b.admit_round,
                                b.first_token_round, b.restarts)


def test_gate_caches_keeps_inactive_slots_bitwise():
    """Inactive slots keep the old cache, active ones take the new, bit
    for bit and exactly as JAX's ``gate_caches`` selects (batch on axis
    1 of every leaf)."""
    rng = np.random.default_rng(0)
    old = [{"b0": {"k": rng.normal(size=(2, 4, 6, 2, 8)).astype(np.float32),
                   "slot_pos": rng.integers(-1, 6, (2, 4, 6)).astype(
                       np.int32)}}]
    new = [{"b0": {"k": rng.normal(size=(2, 4, 6, 2, 8)).astype(np.float32),
                   "slot_pos": rng.integers(-1, 6, (2, 4, 6)).astype(
                       np.int32)}}]
    active = np.array([True, False, True, False])
    want = jax.device_get(jbatching.gate_caches(jnp.asarray(active), old,
                                                 new))
    t_old = caches_from_jax(old, device="cpu")
    t_new = caches_from_jax(new, device="cpu")
    got = gate_caches(torch.from_numpy(active), t_old, t_new)
    for a, b, o, n in zip(jax.tree.leaves(want),
                          jax.tree.leaves(caches_to_numpy(got)),
                          jax.tree.leaves(old), jax.tree.leaves(new)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b[:, ~active], o[:, ~active])
        np.testing.assert_array_equal(b[:, active], n[:, active])


def test_batched_step_matches_jax():
    """One batched step from a carried mid-stream cache (slots at their own
    positions, one inactive): ids equal (or a near-tie), caches within
    STEP_TOL, the inactive slot's rows bit for bit the old ones."""
    jc = j_get_config("qwen3-0.6b", reduced=True)
    jm, tm = JModel(jc), Model(get_config("qwen3-0.6b", reduced=True))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    jstep = jax.jit(jbatching.make_batched_step(jm))
    tstep = make_batched_step(tm)
    rng = np.random.default_rng(5)
    jcache = jm.init_cache(3, 12)
    act = np.array([True, True, False])
    for t in range(5):
        toks = rng.integers(0, jc.vocab_size, (3, 1)).astype(np.int32)
        pos = np.array([t, max(t - 2, 0), 0], np.int32)
        _, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(act))
    old = jax.device_get(jcache)
    tcache = caches_from_jax(old, device="cpu")
    toks = rng.integers(0, jc.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([5, 3, 0], np.int32)
    jn, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(act))
    tn, tcache = tstep(tp, tcache, torch.from_numpy(toks),
                       torch.from_numpy(pos), torch.from_numpy(act))
    assert tn.dtype == torch.int32 and int(tn[2]) == 0
    if not np.array_equal(tn.numpy(), np.asarray(jn)):
        logits, _ = jm.decode_step(jp, jnp.asarray(toks), jnp.asarray(pos),
                                   old)
        for b in np.nonzero(tn.numpy() != np.asarray(jn))[0]:
            lg = np.sort(np.asarray(logits[b, 0, :jc.vocab_size],
                                    np.float64))
            assert lg[-1] - lg[-2] <= NEAR_TIE * np.abs(lg).max()
    for a, b, o in zip(jax.tree.leaves(jax.device_get(jcache)),
                       jax.tree.leaves(caches_to_numpy(tcache)),
                       jax.tree.leaves(old)):
        np.testing.assert_array_equal(b[:, 2], o[:, 2])
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, a)
        else:
            assert np.abs(b - a).max() <= STEP_TOL * np.abs(a).max()


def test_batcher_works_on_the_parameters_device():
    cfg, model, params = _model("nano-lm")
    b = ContinuousBatcher(model, params, max_batch=2, max_len=16)
    assert b.device.type == "cpu"
    assert all(a.device.type == "cpu" for a in tree_leaves(b.caches))
    assert b.step() == 0          # nothing queued: no step taken


@pytest.mark.gpu
def test_staggered_admission_on_card_matches_generate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b = ContinuousBatcher(model, params, max_batch=2, max_len=32)
    reqs = [Request(uid, _prompt(cfg, plen, 10 + uid), gen)
            for uid, (plen, gen) in enumerate([(5, 6), (3, 8), (4, 5)])]
    b.submit(reqs[0])
    b.step()
    b.submit(reqs[1])
    b.submit(reqs[2])
    b.run_until_drained()
    for r in reqs:
        ref = generate(model, params,
                       torch.from_numpy(r.prompt).cuda()[None].long(),
                       r.max_new)
        assert r.out == ref[0, len(r.prompt):].tolist(), r.uid
