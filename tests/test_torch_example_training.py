"""The training twins (``repro_torch.examples.cifar_decentralized`` and
``lm_decentralized``) against the JAX examples' paths, written here with
the JAX package as ``examples/cifar_decentralized.py`` and
``examples/lm_decentralized.py`` write them (the AD-PSGD and A2CiD2
worlds on one compiled schedule, gamma 0.05, the consensus model's test
accuracy), on the CPU at 2 workers, 3 rounds and tiny batches.

Randomness: JAX's weights are carried with ``convert.params_from_jax``,
and both sides read one host-drawn batch table (one fixed batch per
worker, and one held-out batch), as ``test_torch_lm_replay.py`` does.

Tolerances: the compiled schedule exactly; each arm's loss and consensus
traces at rtol 1e-5 (atol 1e-6); the test accuracy exactly.  Then each
twin's ``main`` runs on ``--device cpu`` at a reduced size, and without a
card and without ``--device cpu`` it raises.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.configs import get_config as j_get_config
from repro.data import LMTaskStream as JStream
from repro.models import Model as JModel
from repro.models.resnet import init_resnet as j_init_resnet
from repro.models.resnet import resnet8_cifar as j_resnet8
from repro.models.resnet import resnet_loss as j_resnet_loss
from repro_torch.convert import params_from_jax
from repro_torch.core import build_graph
from repro_torch.data import LMTaskStream
from repro_torch.examples import cifar_decentralized as cifar
from repro_torch.examples import two_arms
from repro_torch.examples import lm_decentralized as lm

W, ROUNDS = 2, 3
TOL = dict(rtol=1e-5, atol=1e-6)


def j_arms(rounds, seed):
    graph = J.ring_graph(W)
    arms = {"adpsgd": J.World(topology=graph,
                              algorithm=J.Algorithm("adpsgd")),
            "a2cid2": J.World(topology=graph,
                              algorithm=J.Algorithm("a2cid2"))}
    return arms, arms["a2cid2"].compile(rounds, seed=seed)


def j_run(grad_fn, params0):
    """Both arms as the JAX examples run them."""
    arms, sched = j_arms(ROUNDS, 0)
    out = {}
    for kind, world in arms.items():
        sim = J.Simulator(grad_fn, world.algorithm_params(), gamma=0.05,
                          backend="ref")
        out[kind] = sim.run_schedule(
            sim.init(params0, W, jax.random.PRNGKey(1)), sched)
    return sched, out


def same_arm(arm, jtrace, what):
    for name in ("loss", "consensus"):
        np.testing.assert_allclose(getattr(arm.trace, name).numpy(),
                                   np.asarray(getattr(jtrace, name)),
                                   err_msg=f"{what} {name}", **TOL)


def test_schedule_is_jaxs():
    for rounds, seed in ((3, 0), (25, 0), (200, 1)):
        _, want = j_arms(rounds, seed)
        _, got = two_arms(build_graph("ring", W), rounds, seed)
        for f in ("partners", "event_times", "event_mask", "grad_times"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)


# ------------------------------------------------------------------ CIFAR

class FixedImages:
    """One fixed image batch per worker and one held-out batch."""

    def __init__(self, images, labels, test_images, test_labels):
        self.batch = {"images": torch.from_numpy(images),
                      "labels": torch.from_numpy(labels).long()}
        self.test = {"images": torch.from_numpy(test_images),
                     "labels": torch.from_numpy(test_labels).long()}

    def sample_workers(self, generator, n):
        return self.batch

    def sample(self, generator):
        return self.test


def _cifar_args(**kw):
    args = cifar.build_parser().parse_args(
        ["--device", "cpu", "--workers", str(W), "--rounds", str(ROUNDS),
         "--batch-size", "4"])
    return argparse.Namespace(**{**vars(args), **kw})


def test_cifar_arms_match_jax():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(W, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (W, 4)).astype(np.int32)
    test_images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    test_labels = rng.integers(0, 10, (16,)).astype(np.int32)
    jcfg = j_resnet8()
    weights = jax.device_get(j_init_resnet(jax.random.PRNGKey(0), jcfg))

    def j_grad_fn(params, key, wid):
        batch = {"images": jnp.asarray(images)[wid],
                 "labels": jnp.asarray(labels)[wid]}
        return jax.value_and_grad(
            lambda p: j_resnet_loss(p, jcfg, batch)[0])(params)

    _, jout = j_run(j_grad_fn, jax.tree.map(jnp.asarray, weights))
    got = cifar.run(_cifar_args(),
                    FixedImages(images, labels, test_images, test_labels),
                    params_from_jax(weights, device="cpu"))
    test = {"images": jnp.asarray(test_images),
            "labels": jnp.asarray(test_labels)}
    for kind, (jstate, jtrace) in jout.items():
        same_arm(got[kind], jtrace, kind)
        _, metrics = j_resnet_loss(J.worker_mean(jstate.x), jcfg, test)
        assert got[kind].test_acc == float(metrics["acc"])
        assert f"test acc {got[kind].test_acc:.2f}" in got[kind].line


def test_cifar_main_on_cpu(capsys):
    out = cifar.main(["--device", "cpu", "--rounds", "2", "--workers", "2",
                      "--batch-size", "2"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [arm.line for arm in out.values()]
    assert printed[0].startswith("baseline (ring): loss ")
    assert printed[1].startswith("A2CiD2   (ring): loss ")
    for arm in out.values():
        assert bool(torch.isfinite(arm.trace.loss).all())
        assert arm.trace.loss.shape == (2,)


# --------------------------------------------------------------------- LM

class FixedTokens:
    """One fixed (B, S+1) token batch per worker; ``bayes_ce`` is the
    example's stream's."""

    def __init__(self, table, stream):
        t = torch.from_numpy(table).long()
        self.batch = {"inputs": t[..., :-1], "labels": t[..., 1:]}
        self.bayes_ce = stream.bayes_ce

    def sample_workers(self, generator, n):
        return self.batch


def test_lm_arms_match_jax():
    jcfg = j_get_config("nano-lm", reduced=True)
    jmodel = JModel(jcfg)
    weights = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    table = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (W, 2, 9)).astype(np.int32)

    def j_grad_fn(params, key, wid):
        tok = jnp.asarray(table)[wid]
        batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
        return jax.value_and_grad(
            lambda p: jmodel.loss(p, batch)[0])(params)

    _, jout = j_run(j_grad_fn, jax.tree.map(jnp.asarray, weights))
    args = lm.build_parser().parse_args(
        ["--device", "cpu", "--workers", str(W), "--rounds", str(ROUNDS),
         "--batch-size", "2", "--seq-len", "8"])
    stream = LMTaskStream(jcfg.vocab_size, 8, 2, concentration=0.15,
                          device="cpu")
    header, got = lm.run(args, FixedTokens(table, stream),
                         params_from_jax(weights, device="cpu"))
    jstream = JStream(vocab_size=jcfg.vocab_size, seq_len=8, batch_size=2,
                      concentration=0.15)
    n_params = sum(p.size for p in jax.tree.leaves(weights))
    assert header == (f"nano-lm: {n_params / 1e6:.1f}M params, {W} workers, "
                      f"ring graph, bayes CE {jstream.bayes_ce():.3f}")
    for kind, (_, jtrace) in jout.items():
        same_arm(got[kind], jtrace, kind)


def test_lm_main_on_cpu(capsys):
    header, out = lm.main(["--device", "cpu", "--rounds", "2", "--workers",
                           "2", "--batch-size", "1", "--seq-len", "8"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [header] + [arm.line for arm in out.values()]
    assert header.startswith("nano-lm: 0.3M params, 2 workers, ring graph, "
                             "bayes CE ")
    assert printed[1].startswith("baseline: loss ")
    assert printed[2].startswith("A2CiD2  : loss ")
    for arm in out.values():
        assert bool(torch.isfinite(arm.trace.loss).all())


def test_mains_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cifar.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--rounds", "1"])
