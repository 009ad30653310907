"""Port parity for the LM slice: the Markov token stream's fixed structure is
bitwise the JAX package's, a nano-lm gossip replay (``train_bench``, n = 4
on a ring, 3 rounds) follows the JAX ``run_schedule`` (``backend="ref"``),
the prefill step equals the JAX forward, and ``run_sim`` runs the whole
launcher on the CPU.

Randomness: torch generators cannot reproduce ``jax.random``, so both
replays read one host-drawn token table (one fixed batch per worker) and
the stream's own draws are only checked for shape and range.

Tolerances: the replay rtol 1e-4 (atol 1e-6) on losses, consensus and the
final weights (the model's f32 reductions run in another order in XLA and
PyTorch, and gossip mixes the differences); the prefill logits 1e-5 of
their largest magnitude; ``bayes_ce`` 1e-12 (both are the same numpy
code).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nano_lm import train_bench as j_train_bench
from repro.core import Simulator as JSim
from repro.core import make_schedule as j_make_schedule
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro.data import LMTaskStream as JStream
from repro.data import make_lm_stream as j_make_lm_stream
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.nano_lm import train_bench
from repro_torch.convert import params_from_jax
from repro_torch.core import (Simulator, make_schedule, params_from_graph,
                              ring_graph)
from repro_torch.core.tree import tree_leaves
from repro_torch.data import LMTaskStream, make_lm_stream
from repro_torch.launch import train
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.transformer import Model, lm_grad_fn

N, BATCH, SEQ, ROUNDS = 4, 2, 16, 3
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("vocab,seed,conc", [(64, 1234, 0.3),
                                             (257, 7, 0.5)])
def test_stream_structure_matches_jax(vocab, seed, conc):
    t = LMTaskStream(vocab, 8, 2, concentration=conc, seed=seed,
                     device="cpu")
    j = JStream(vocab, 8, 2, concentration=conc, seed=seed)
    np.testing.assert_array_equal(t.transition_logits(),
                                  np.asarray(j.transition_logits()))
    assert abs(t.bayes_ce() - j.bayes_ce()) <= 1e-12
    cfg = get_config("nano-lm", reduced=True)
    made, jmade = make_lm_stream(cfg, 8, 2, device="cpu"), \
        j_make_lm_stream(cfg, 8, 2)
    assert (made.vocab_size, made.seq_len, made.batch_size, made.seed) == \
        (jmade.vocab_size, jmade.seq_len, jmade.batch_size, jmade.seed)


def test_stream_draws_and_reshape():
    s = LMTaskStream(50, 12, 3, device="cpu")
    b = s.sample_workers(torch.Generator().manual_seed(0), 4)
    assert b["inputs"].shape == b["labels"].shape == (4, 3, 12)
    assert int(b["inputs"].min()) >= 0 and int(b["inputs"].max()) < 50
    # labels are the inputs shifted by one token
    assert torch.equal(b["inputs"][..., 1:], b["labels"][..., :-1])
    again = s.sample_workers(torch.Generator().manual_seed(0), 4)
    assert torch.equal(again["labels"], b["labels"])
    one = s.sample(torch.Generator().manual_seed(1))
    assert one["inputs"].shape == (3, 12)
    long = s.reshaped(seq_len=40, batch_size=1)
    assert long._logits is s._logits          # drawn once, shared
    assert long.sample(torch.Generator())["inputs"].shape == (1, 40)
    # the chain is learnable: most next tokens follow a few likely moves
    logits = torch.from_numpy(s.transition_logits())
    top = logits.topk(5, dim=-1).indices
    hits = (top[b["inputs"]] == b["labels"][..., None]).any(-1)
    assert hits.float().mean() > 0.5


class _FixedTokens:
    """One fixed (B, S+1) token batch per worker, drawn with numpy; every
    gradient tick reads it (the JAX side indexes the same table)."""

    def __init__(self, table):
        t = torch.from_numpy(table).long()
        self.batch = {"inputs": t[..., :-1], "labels": t[..., 1:]}

    def sample_workers(self, generator, n):
        return self.batch


@pytest.mark.parametrize("accelerated", [False, True])
def test_lm_replay_matches_jax_run_schedule(accelerated):
    jcfg, tcfg = j_train_bench(), train_bench()
    jmodel = JModel(jcfg)
    weights = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    table = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (N, BATCH, SEQ + 1)).astype(np.int32)

    def j_grad_fn(p, key, wid):
        tok = jnp.asarray(table)[wid]
        batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
        return jax.value_and_grad(lambda q: jmodel.loss(q, batch)[0])(p)

    jsim = JSim(j_grad_fn, j_params(j_ring(N), accelerated), 0.05,
                backend="ref")
    jstate = jsim.init(jax.tree.map(jnp.asarray, weights), N,
                       jax.random.PRNGKey(0))
    jf, jt = jsim.run_schedule(jstate, j_make_schedule(j_ring(N), ROUNDS,
                                                       seed=0))

    tsim = Simulator(lm_grad_fn(Model(tcfg), _FixedTokens(table)),
                     params_from_graph(ring_graph(N), accelerated), 0.05,
                     device="cpu")
    tstate = tsim.init(params_from_jax(weights, device="cpu"), N,
                       torch.Generator().manual_seed(0))
    tf, tt = tsim.run_schedule(tstate, make_schedule(ring_graph(N), ROUNDS,
                                                     seed=0))
    for name in ("loss", "consensus", "mean_param_norm"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)
    for a, b in zip(jax.tree.leaves(jf.x), tree_leaves(tf.x)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert bool(torch.isfinite(tt.loss).all())


def test_prefill_step_matches_jax_forward():
    jcfg = j_train_bench()
    jmodel = JModel(jcfg)
    weights = jax.device_get(jmodel.init(jax.random.PRNGKey(2)))
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (3, 40)).astype(np.int32)
    want = np.asarray(j_make_prefill_step(jmodel)(weights,
                                                  {"inputs": toks}))
    for impl in ("xla", "pallas"):
        model = Model(train_bench().with_updates(attention_impl=impl))
        got = make_prefill_step(model)(params_from_jax(weights, "cpu"),
                                       {"inputs": torch.from_numpy(toks)})
        assert not got.requires_grad
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


def _args(**kw):
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--workers", "4", "--steps", "2",
         "--batch-size", "2", "--seq-len", "16"])
    return argparse.Namespace(**{**vars(args), **kw})


def test_run_sim_on_cpu(capsys):
    run = train.run_sim(_args(acid=True))
    assert run.trace.loss.shape == (2,)
    assert bool(torch.isfinite(run.trace.loss).all())
    assert bool(torch.isfinite(run.trace.consensus).all())
    assert run.model.cfg == get_config("nano-lm", reduced=True)
    lead = tree_leaves(run.state.x)[0]
    assert lead.shape[0] == 4 and lead.device.type == "cpu"
    out = capsys.readouterr().out
    assert "4 workers, ring graph, acid=True" in out and "bayes-CE" in out
    # a caller's stream replaces the one args would build
    stream = LMTaskStream(run.model.cfg.vocab_size, 16, 2, device="cpu")
    again = train.run_sim(_args(bayes_ce=False), stream=stream)
    assert again.stream is stream
    assert "bayes-CE" not in capsys.readouterr().out


def test_unported_launch_modes_raise(tmp_path, capsys):
    """``--mode sync`` and ``--ckpt`` are ported: both run on the CPU, and
    the checkpoint of each mode reloads bit for bit."""
    from repro_torch.checkpoint import restore
    train.main(["--mode", "sync", "--device", "cpu", "--steps", "2",
                "--batch-size", "2", "--seq-len", "8", "--no-bayes-ce",
                "--ckpt", str(tmp_path / "sync")])
    out = capsys.readouterr().out
    assert "[train/sync] step     1 loss" in out and "checkpoint" in out
    args = _args(bayes_ce=False, ckpt=str(tmp_path / "sim"))
    run = train.run_sim(args)
    step, x = restore(args.ckpt, run.state.x)
    assert step == args.steps
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(x), tree_leaves(run.state.x)))


def test_worker_stream_keys_are_distinct_and_reproducible():
    """The port's ``WorkerStream`` as JAX's test_substrates holds JAX's:
    each (worker, step) its own stream, the same key the same draws."""
    from repro_torch.data import WorkerStream
    ws = WorkerStream(base_seed=0, device="cpu")
    draws = {(w, s): torch.rand(4, generator=ws.key(w, s))
             for w in range(3) for s in range(3)}
    assert torch.equal(draws[(1, 2)], torch.rand(4, generator=ws.key(1, 2)))
    values = [tuple(d.tolist()) for d in draws.values()]
    assert len(set(values)) == len(values)
    other = WorkerStream(base_seed=1, device="cpu")
    assert not torch.equal(torch.rand(4, generator=other.key(1, 2)),
                           draws[(1, 2)])
