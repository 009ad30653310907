"""Port parity for synchronous training (``launch/steps.make_train_step``,
``launch/train.run_sync``) and the transformer's ``remat``: on reduced
nano-lm with the JAX package's weights carried by ``convert`` and a
host-numpy token batch, two steps of the port's train step follow two of
JAX's (plain, with a global-norm clip, with two micro-batches), and
``remat=True`` changes no number.

Tolerances: loss, metrics and every parameter leaf within 1e-4 of the
largest magnitude of the JAX tensor compared (the port's LM gradient
tolerance: the same f32 matmuls and reductions summed in another order by
XLA and PyTorch); ``remat`` against no ``remat`` in the port exactly.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import Model as JModel
from repro.optim import sgd as j_sgd
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import Model
from repro_torch.optim import sgd

B, S, LR, STEPS, TOL = 4, 24, 0.05, 2, 1e-4


def _close(port, want, tol=TOL):
    port = port.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


def _batches(cfg, m=1):
    """STEPS token batches from a numpy seed: (B, S), or (m, B/m, S) for m
    micro-batches."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        inputs, labels = tok[:, :-1], tok[:, 1:]
        if m > 1:
            inputs = inputs.reshape(m, B // m, S)
            labels = labels.reshape(m, B // m, S)
        out.append((inputs, labels))
    return out


def _setup():
    jcfg = j_get_config("nano-lm", reduced=True)
    jm, tm = JModel(jcfg), Model(get_config("nano-lm", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, tm, jp


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip=0.5),
                                dict(num_microbatches=2),
                                dict(grad_clip=1e-3, num_microbatches=2)],
                         ids=["plain", "clip", "micro", "clip-micro"])
def test_train_step_matches_jax(kw):
    jcfg, jm, tm, jp = _setup()
    jstep, jopt = j_make_train_step(jm, j_sgd(), lr=LR, remat=False, **kw)
    tstep, topt = make_train_step(tm, sgd(), lr=LR, remat=False, **kw)
    jstate = JTrainState(jp, jopt.init(jp))
    tstate = train_state_from_jax(jax.device_get(jstate), device="cpu")
    for inputs, labels in _batches(jcfg, kw.get("num_microbatches", 1)):
        jstate, jmet = jax.jit(jstep)(jstate, {
            "inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)})
        tstate, tmet = tstep(tstate, {
            "inputs": torch.from_numpy(inputs).long(),
            "labels": torch.from_numpy(labels).long()})
        assert tmet.keys() == jmet.keys()
        for k in jmet:
            _close(tmet[k], jmet[k])
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(
            jstate.params)):
        _close(a, b)
    for a, b in zip(tree_leaves(tstate.opt.mu), jax.tree.leaves(
            jstate.opt.mu)):
        _close(a, b)
    assert int(tstate.opt.step) == int(jstate.opt.step) == STEPS


@pytest.mark.parametrize("m", [1, 2])
def test_remat_changes_no_number(m):
    jcfg, _, tm, jp = _setup()
    outs = []
    for remat in (False, True):
        step, opt = make_train_step(tm, sgd(), lr=LR, remat=remat,
                                    num_microbatches=m)
        state = train_state_from_jax(jax.device_get(
            JTrainState(jp, j_sgd().init(jp))), device="cpu")
        state = TrainState(state.params, opt.init(state.params))
        losses = []
        for inputs, labels in _batches(jcfg, m):
            state, met = step(state, {
                "inputs": torch.from_numpy(inputs).long(),
                "labels": torch.from_numpy(labels).long()})
            losses.append(met["loss"])
        outs.append((torch.stack(losses), tree_leaves(state.params)))
    (l0, p0), (l1, p1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_remat_forward_and_grads_equal_plain():
    _, _, tm, jp = _setup()
    from repro_torch.convert import params_from_jax
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (2, S + 1))).long()
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    grads = []
    for remat in (False, True):
        params = params_from_jax(jax.device_get(jp), device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = tm.loss(params, batch, remat=remat)
        grads.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def _args(tmp_path, **kw):
    args = train.build_parser().parse_args(
        ["--mode", "sync", "--device", "cpu", "--steps", "3",
         "--batch-size", "2", "--seq-len", "16", "--no-bayes-ce",
         "--ckpt", str(tmp_path)])
    return argparse.Namespace(**{**vars(args), **kw})


def test_run_sync_and_its_checkpoint(tmp_path, capsys):
    run = train.run_sync(_args(tmp_path))
    assert run.losses.shape == (3,) and bool(torch.isfinite(
        run.losses).all())
    assert int(run.state.opt.step) == 3
    assert run.model.cfg == get_config("nano-lm", reduced=True)
    out = capsys.readouterr().out
    assert "[train/sync] 3 steps in" in out and "checkpoint" in out
    step, params = restore(str(tmp_path), run.state.params)
    assert step == 3
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(run.state.params)))
    # the CLI runs the same loop: the same seeds give the same losses
    train.main(["--mode", "sync", "--device", "cpu", "--steps", "3",
                "--batch-size", "2", "--seq-len", "16", "--no-bayes-ce"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train/sync] step")]
    assert [ln.split()[-1] for ln in lines] == [
        f"{float(v):.4f}" for v in run.losses]
