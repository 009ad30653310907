"""Port parity for ``optim/``: ``sgd`` (heavy-ball and Nesterov) and
``adamw`` take the same steps as the JAX package's on a ResNet tree and a
transformer tree, the weight-decay mask is the JAX mask leaf for leaf, and
``clip_by_global_norm``, ``apply_updates`` and the schedules agree.

Tolerances: f32 rtol 1e-6 (atol 1e-7): the same sequence of correctly
rounded f32 operations, up to an ulp of ``pow`` and the order of a sum.
bf16 ``sgd``: bit for bit, since every Python scalar is rounded to bf16
before it multiplies, as JAX binds a weak scalar.  bf16 ``adamw`` runs its
moments in f32 and casts the parameters once at the end: bit for bit too.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import resnet as jres
from repro.models.transformer import Model as JModel
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 params_to_numpy)
from repro_torch.core.tree import (SequenceKey, tree_flatten,
                                   tree_flatten_with_path, tree_leaves)
from repro_torch.optim import (OptState, adamw, apply_updates,
                               clip_by_global_norm, constant, cosine,
                               goyal_warmup_step_decay, sgd)
from repro_torch.optim.optimizers import weight_decay_mask

F32 = dict(rtol=1e-6, atol=1e-7)


@functools.cache
def _resnet8():
    return jax.device_get(jres.init_resnet(jax.random.PRNGKey(0),
                                           jres.resnet8_cifar()))


@functools.cache
def _transformer():
    cfg = j_get_config("qwen3-0.6b", reduced=True)
    return jax.device_get(JModel(cfg).init(jax.random.PRNGKey(1)))


TREES = {"resnet8": _resnet8, "qwen3-reduced": _transformer}


def _j_mask(tree):
    return [0.0 if jopt._is_norm_scale(p) else 1.0
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)


def _grads(tree, seed, dtype):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32)
        .astype(dtype), tree)


def _assert_tree(port, want, dtype):
    got = [np.asarray(a, np.float32) for a in
           tree_leaves(params_to_numpy(port))]
    exp = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        if dtype == np.float32:
            np.testing.assert_allclose(g, e, **F32)
        else:
            np.testing.assert_array_equal(g, e)


def test_weight_decay_mask_equals_jax_on_resnet18():
    # the tree's structure and shapes, without running the initializer
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: jres.init_resnet(jax.random.PRNGKey(0),
                                 jres.resnet18_cifar())))
    port = params_from_jax(tree, device="cpu")
    mask = weight_decay_mask(port)
    assert mask == _j_mask(tree)
    assert len(mask) == 56 and mask.count(0.0) == 34
    # the head bias is decayed: a tuple position adds an empty name
    paths = [p for p, _ in tree_flatten_with_path(port)[0]]
    head_bias = paths.index((paths[1][0], SequenceKey(1)))
    assert mask[head_bias] == 1.0


@pytest.mark.parametrize("tree", sorted(TREES))
def test_path_flatten_matches_jax(tree):
    np_tree = TREES[tree]()
    port = params_from_jax(np_tree, device="cpu")
    got = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
            tuple(leaf.shape)) for p, leaf in tree_flatten_with_path(port)[0]]
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.shape(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]]
    assert got == want
    assert weight_decay_mask(port) == _j_mask(np_tree)
    assert tree_flatten(port)[1].flatten_up_to(port) == tree_leaves(port)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, weight_decay=5e-4)),
    ("sgd", dict(momentum=0.9, weight_decay=5e-4, nesterov=True)),
    ("adamw", dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)),
])
def test_optimizer_steps_match_jax(tree, dtype, name, kw):
    params = _cast(TREES[tree](), dtype)
    j = getattr(jopt, name)(**kw)
    t = {"sgd": sgd, "adamw": adamw}[name](**kw)
    jp, js = params, j.init(jax.tree.map(jnp.asarray, params))
    tp = params_from_jax(params, device="cpu")
    ts = t.init(tp)
    for k, lr in enumerate((0.1, 0.05, 0.3)):
        g = _grads(params, seed=k, dtype=dtype)
        jp, js = j.update(jax.tree.map(jnp.asarray, g), js,
                          jax.tree.map(jnp.asarray, jp),
                          jnp.asarray(lr, jnp.float32))
        tp, ts = t.update(params_from_jax(g, device="cpu"), ts, tp, lr)
    jp, js = jax.device_get((jp, js))
    _assert_tree(tp, jp, dtype)
    _assert_tree(ts.mu, js.mu, dtype if name == "sgd" else np.float32)
    if name == "adamw":
        _assert_tree(ts.nu, js.nu, np.float32)
    assert int(ts.step) == int(js.step) == 3


def test_stacked_update_is_the_vmapped_update():
    """On worker-stacked leaves with a (W,) step counter the update equals
    ``jax.vmap`` of the JAX update (the stacked trainer's use)."""
    base = TREES["resnet8"]()
    rng = np.random.default_rng(3)
    stack = jax.tree.map(lambda a: np.stack(
        [np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32)
         for _ in range(3)]), base)
    g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     stack)
    for kw in (dict(b1=0.8),):
        j = jopt.adamw(**kw)
        t = adamw(**kw)
        js = jax.vmap(j.init)(stack)
        jp, js = jax.vmap(lambda g_, s_, p_: j.update(
            g_, s_, p_, jnp.asarray(0.1, jnp.float32)))(g, js, stack)
        tp = params_from_jax(stack, device="cpu")
        ts = t.init(tp)
        ts = ts._replace(step=ts.step.repeat(3))
        tp, ts = t.update(params_from_jax(g, device="cpu"), ts, tp, 0.1)
        _assert_tree(tp, jax.device_get(jp), np.float32)
        assert ts.step.tolist() == [1, 1, 1]


def test_opt_state_carries_from_jax():
    params = TREES["resnet8"]()
    j = jopt.adamw()
    js = jax.device_get(j.init(params))
    ts = opt_state_from_jax(js, device="cpu")
    assert isinstance(ts, OptState) and int(ts.step) == 0
    assert ts.mu.keys() == params.keys() and ts.nu is not None


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_clip_and_apply_updates_match_jax(dtype):
    g = _grads(TREES["resnet8"](), seed=9, dtype=dtype)
    tg = params_from_jax(g, device="cpu")
    for max_norm in (1.0, 1e6):
        _assert_tree(clip_by_global_norm(tg, max_norm),
                     jax.device_get(jopt.clip_by_global_norm(
                         jax.tree.map(jnp.asarray, g), max_norm)),
                     np.float32 if max_norm > 1e3 else dtype)
    p = _grads(g, seed=10, dtype=dtype)
    _assert_tree(apply_updates(params_from_jax(p, device="cpu"), tg),
                 jax.device_get(jopt.apply_updates(
                     jax.tree.map(jnp.asarray, p),
                     jax.tree.map(jnp.asarray, g))), dtype)


def test_schedules_match_jax():
    steps = np.arange(0, 400, 7, dtype=np.int32)
    pairs = [
        (jsched.constant(0.1), constant(0.1)),
        (jsched.goyal_warmup_step_decay(0.1, 16, 3, milestones=(30, 60, 80),
                                        warmup_epochs=5),
         goyal_warmup_step_decay(0.1, 16, 3, milestones=(30, 60, 80),
                                 warmup_epochs=5)),
        (jsched.cosine(3e-4, 50, 300), cosine(3e-4, 50, 300)),
        (jsched.cosine(1.0, 0, 10, final_frac=0.0),
         cosine(1.0, 0, 10, final_frac=0.0)),
    ]
    for j, t in pairs:
        got = np.array([float(t(torch.tensor(s))) for s in steps],
                       np.float32)
        want = np.array([float(j(jnp.asarray(s))) for s in steps],
                        np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
