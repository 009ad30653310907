"""Port parity for the ResNet and the whole training slice.

A small config of the paper's family (two stages, width 8, GroupNorm with
2 groups, a stride-2 projected block) carries the JAX package's weights
into the port: logits, loss and gradients agree, and the whole slice — n=4
workers gossiping on a ring for 2 rounds, each worker on a fixed numpy
batch — follows the JAX ``run_schedule`` (``backend="ref"``).

Tolerances: model outputs and gradients rtol 1e-4 (atol 1e-5) — XLA and
PyTorch sum convolutions and GroupNorm moments in other orders; the slice
rtol 1e-4 (atol 1e-5) on losses, consensus and final weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Simulator as JSim
from repro.core import make_schedule as j_make_schedule
from repro.core import params_from_graph as j_params
from repro.core import ring_graph as j_ring
from repro.data import SyntheticCIFAR as JCIFAR
from repro.models import resnet as jres
from repro_torch.convert import params_from_jax
from repro_torch.core import (Simulator, make_schedule, params_from_graph,
                              ring_graph)
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.data import SyntheticCIFAR
from repro_torch.models import resnet as tres

J_CFG = jres.ResNetConfig("tiny", (1, 1), 8, 10, groups=2)
T_CFG = tres.ResNetConfig("tiny", (1, 1), 8, 10, groups=2)
TOL = dict(rtol=1e-4, atol=1e-5)
N, BATCH = 4, 4


@pytest.fixture(scope="module")
def weights():
    return jax.device_get(jres.init_resnet(jax.random.PRNGKey(0), J_CFG))


def _batch(seed, lead=()):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=lead + (BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=lead + (BATCH,)).astype(np.int32)
    return imgs, labels


def test_same_padding_matches_xla():
    # 3x3 stride 2 on an even input pads (0, 1): (1, 1) would shift the grid
    assert tres._same_pad(32, 3, 2) == (0, 1)
    assert tres._same_pad(32, 3, 1) == (1, 1)
    assert tres._same_pad(32, 1, 2) == (0, 0)


def test_logits_loss_grads_match_jax(weights):
    imgs, labels = _batch(0)
    jbatch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    tp = params_from_jax(weights, device="cpu")
    tbatch = {"images": torch.from_numpy(imgs),
              "labels": torch.from_numpy(labels)}
    jlogits = jres.apply_resnet(weights, J_CFG, jbatch["images"])
    tlogits = tres.apply_resnet(tp, T_CFG, tbatch["images"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)

    def jloss(p):
        return jres.resnet_loss(p, J_CFG, jbatch)[0]

    jl, jg = jax.value_and_grad(jloss)(weights)
    tg, tl = torch.func.grad_and_value(
        lambda p: tres.resnet_loss(p, T_CFG, tbatch)[0])(tp)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # the nn.Module view runs the same function on the same leaf order
    module = tres.ResNet(T_CFG, tp)
    torch.testing.assert_close(module(tbatch["images"]), tlogits)


def test_init_structure_matches_jax(weights):
    tp = tres.init_resnet(torch.Generator().manual_seed(0), T_CFG)
    jl, _ = jax.tree_util.tree_flatten(weights)
    tl, _ = tree_flatten(tp)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    full = tres.init_resnet(torch.Generator().manual_seed(0),
                            tres.resnet18_cifar())
    leaves = tree_leaves(full)
    assert len(leaves) == 56
    assert sum(a.numel() for a in leaves) == 11_171_274


def test_synthetic_cifar_prototypes_bitwise():
    np.testing.assert_array_equal(
        SyntheticCIFAR(device="cpu").prototypes(),
        np.asarray(JCIFAR().prototypes()))
    s = SyntheticCIFAR(batch_size=5, device="cpu")
    b = s.sample_workers(torch.Generator().manual_seed(1), 3)
    assert b["images"].shape == (3, 5, 32, 32, 3)
    assert b["labels"].shape == (3, 5) and b["labels"].max() < 10
    one = s.sample(torch.Generator().manual_seed(1))
    assert one["images"].shape == (5, 32, 32, 3)


class _FixedBatches:
    """Per-worker batches drawn once with numpy; every tick reuses them."""

    def __init__(self, imgs, labels):
        self.batch = {"images": torch.from_numpy(imgs),
                      "labels": torch.from_numpy(labels)}

    def sample_workers(self, generator, n):
        return self.batch


@pytest.mark.parametrize("accelerated", [False, True])
def test_slice_matches_jax_run_schedule(weights, accelerated):
    imgs, labels = _batch(1, lead=(N,))

    def j_grad_fn(p, key, wid):
        batch = {"images": jnp.asarray(imgs)[wid],
                 "labels": jnp.asarray(labels)[wid]}
        return jax.value_and_grad(
            lambda q: jres.resnet_loss(q, J_CFG, batch)[0])(p)

    jsim = JSim(j_grad_fn, j_params(j_ring(N), accelerated), 0.05,
                backend="ref")
    jstate = jsim.init(jax.tree.map(jnp.asarray, weights), N,
                       jax.random.PRNGKey(0))
    jf, jt = jsim.run_schedule(jstate, j_make_schedule(j_ring(N), 2, seed=0))

    tsim = Simulator(tres.resnet_grad_fn(T_CFG, _FixedBatches(imgs, labels)),
                     params_from_graph(ring_graph(N), accelerated), 0.05,
                     device="cpu")
    tstate = tsim.init(params_from_jax(weights, device="cpu"), N,
                       torch.Generator().manual_seed(0))
    tf, tt = tsim.run_schedule(tstate, make_schedule(ring_graph(N), 2,
                                                     seed=0))
    for name in ("loss", "consensus", "mean_param_norm"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)
    for a, b in zip(jax.tree.leaves(jf.x), tree_leaves(tf.x)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
