"""The dry run's shapes, partition rules and shape-only parameters against
the JAX package, at full size and on metadata only.

  * ``SHAPES``, ``adapt_config``, ``data.lm_batch_specs`` and every input
    spec's shape and dtype equal the JAX package's ``ShapeDtypeStruct``s
    for every config x shape; the decode caches equal JAX's ``eval_shape`` of
    ``init_cache`` by shape;
  * every parameter leaf's ``param_spec``, every cache leaf's
    ``cache_spec``, the batch specs and the worker-stacked parameter specs
    equal JAX's on the single-pod, multi-pod and gossip meshes for all 11
    configs (JAX's ``AbstractMesh``, the port's ``launch.mesh``);
  * JAX's five ``test_sharding_specs.py`` cases, mirrored;
  * ``Model.init(SHAPE_ONLY)`` is ``init``'s tree on reduced configs and
    JAX's ``eval_shape`` tree at full size, every leaf on the meta device;
  * the dry run's ``_param_counts`` (total and active) equal JAX's.
"""
import dataclasses
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsharding
from repro import shapes as jshapes
from repro.configs import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.launch import shardings as JS
from repro.models.transformer import Model as JModel
from repro_torch import sharding, shapes
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import (AbstractMesh as TMesh,
                                     make_gossip_mesh, make_production_mesh,
                                     mesh_devices, rules_for)
from repro_torch.models.layers import SHAPE_ONLY
from repro_torch.models.transformer import Model

from port_parity import as_jax_fields


CONFIGS = ARCHITECTURES + ("nano-lm",)
MESHES = {
    "single": (make_production_mesh(), AbstractMesh((16, 16),
                                                    ("data", "model"))),
    "multi": (make_production_mesh(multi_pod=True),
              AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
    "gossip": (make_gossip_mesh(), AbstractMesh((8, 8, 8),
                                                ("worker", "data", "model"))),
}


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _jax_leaves(tree) -> dict:
    return {JS._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {S._path_str(p): leaf for p, leaf in tree_flatten_with_path(tree)[0]
            if leaf is not None}


def _same_shapes(port: dict, want: dict, dtypes: bool = True) -> None:
    assert sorted(port) == sorted(want)
    for k, leaf in port.items():
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        if dtypes:
            assert _dtype(leaf.dtype) == _dtype(want[k].dtype), k


@pytest.fixture(scope="module")
def abstract():
    """Per config: (the port's meta params, JAX's eval_shape params)."""
    out = {}
    for name in CONFIGS:
        jm = JModel(jax_config(name))
        out[name] = (Model(get_config(name)).init(SHAPE_ONLY),
                     jax.eval_shape(lambda jm=jm: jm.init(
                         jax.random.PRNGKey(0))))
    return out


# ------------------------------------------------------------------ shapes

def test_shapes_and_rules_equal_jax():
    assert shapes.SHAPES == {k: shapes.InputShape(**dataclasses.asdict(v))
                             for k, v in jshapes.SHAPES.items()}
    for name in ("SINGLE_POD_RULES", "MULTI_POD_RULES", "GOSSIP_RULES",
                 "REPLAY_RULES"):
        assert getattr(sharding, name) == getattr(jsharding, name)
    rules = jsharding.MULTI_POD_RULES
    axes = ("batch", None, "heads", "seq", "nope")
    assert sharding.logical_to_spec(axes, rules) == tuple(
        jsharding.logical_to_spec(axes, rules))
    assert sharding.logical_to_spec(axes) == (None,) * 5
    for (port, jm) in MESHES.values():
        assert rules_for(port) == jmesh.rules_for(jm)
        assert mesh_devices(port) == jm.size
        assert port.shape == dict(jm.shape)


@pytest.mark.parametrize("name", CONFIGS)
def test_input_specs_equal_jax(name):
    cfg, jcfg = get_config(name), jax_config(name)
    for shape in shapes.SHAPES:
        assert as_jax_fields(shapes.adapt_config(
            cfg, shapes.shape_for(shape))) == dataclasses.asdict(
            jshapes.adapt_config(jcfg, jshapes.shape_for(shape)))
        port = shapes.input_specs(cfg, shape)
        _same_shapes(port, jshapes.input_specs(jcfg, shape))
        assert all(t.is_meta for t in port.values())
    # the decode caches, by shape (JAX's eval_shape of init_cache)
    for shape in ("decode_32k", "long_500k"):
        s = shapes.shape_for(shape)
        port = shapes.cache_specs(shapes.adapt_config(cfg, s), s)
        want = jshapes.cache_specs(jshapes.adapt_config(jcfg, s), s)
        _same_shapes(_port_leaves(port), _jax_leaves(want), dtypes=False)
        assert all(t.is_meta for t in _port_leaves(port).values())


def test_lm_batch_specs_equal_jax():
    from repro.data.pipeline import lm_batch_specs as jax_specs
    from repro_torch.data import lm_batch_specs
    port = lm_batch_specs(32000, 8, 128)
    _same_shapes(port, jax_specs(32000, 8, 128))
    assert all(t.is_meta for t in port.values())


# ------------------------------------------------------- partition specs

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_partition_specs_equal_jax(abstract, name, mesh_name):
    mesh, jm = MESHES[mesh_name]
    rules = rules_for(mesh)
    params, jparams = abstract[name]
    port, want = _port_leaves(params), _jax_leaves(jparams)
    for serve in (False, True):
        r = dict(rules, fsdp=None) if serve else rules
        for path, leaf in port.items():
            assert S.param_spec(path, leaf, mesh, r) == tuple(
                JS.param_spec(path, want[path], jm, r)), (path, r)
    cfg, jcfg = get_config(name), jax_config(name)
    for shape in ("decode_32k", "long_500k"):
        s = shapes.shape_for(shape)
        caches = _port_leaves(shapes.cache_specs(shapes.adapt_config(cfg, s),
                                                 s))
        jcaches = _jax_leaves(jshapes.cache_specs(
            jshapes.adapt_config(jcfg, s), s))
        for path, leaf in caches.items():
            assert S.cache_spec(path, leaf, mesh, rules) == tuple(
                JS.cache_spec(path, jcaches[path], jm, rules)), path
    for shape in shapes.SHAPES:
        batch = shapes.input_specs(cfg, shape)
        jbatch = jshapes.input_specs(jcfg, shape)
        got = S.batch_shardings(batch, mesh, rules)
        jgot = JS.batch_shardings(jbatch, jm, rules)
        assert {k: v for k, v in got.items()} == {
            k: tuple(v.spec) for k, v in jgot.items()}
        micro = {k: torch.empty((4, v.shape[0] // 4) + tuple(v.shape[1:]),
                                device="meta") for k, v in batch.items()
                 if v.dim()}
        jmicro = {k: jax.ShapeDtypeStruct(tuple(micro[k].shape), v.dtype)
                  for k, v in jbatch.items() if k in micro}
        got = S.batch_shardings(micro, mesh, rules, leading_microbatch=True)
        jgot = JS.batch_shardings(jmicro, jm, rules, leading_microbatch=True)
        assert got == {k: tuple(v.spec) for k, v in jgot.items()}
    if mesh_name == "gossip":
        stacked = tree_map(lambda t: torch.empty((8,) + tuple(t.shape),
                                                 device="meta"), params)
        jstacked = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            (8,) + tuple(t.shape), t.dtype), jparams)
        got = _port_leaves(S.stacked_param_shardings(stacked, mesh, rules))
        jgot = _jax_leaves(JS.stacked_param_shardings(jstacked, jm, rules))
        assert got == {k: tuple(v.spec) for k, v in jgot.items()}


# JAX's five test_sharding_specs.py cases, on the port's functions

class FakeLeaf:
    def __init__(self, shape):
        self.shape = shape


FAKE = TMesh(("data", "model"), (16, 16))
RULES = {"batch": "data", "heads": "model", "ffn": "model",
         "vocab": "model", "expert": "model", "fsdp": "data", "tp": "model"}


def test_param_spec_2d_rules():
    assert S.param_spec("groups/0/b0/mixer/wq", FakeLeaf((28, 1024, 2048)),
                        FAKE, RULES) == (None, "data", "model")
    assert S.param_spec("embed/tok", FakeLeaf((152064, 1024)),
                        FAKE, RULES) == ("model", "data")
    assert S.param_spec("groups/0/b0/mlp/w_down", FakeLeaf((28, 3072, 1024)),
                        FAKE, RULES) == (None, "model", "data")


def test_param_spec_moe_3d():
    spec = S.param_spec("groups/1/b0/mlp/moe_up",
                        FakeLeaf((58, 256, 7168, 2048)), FAKE, RULES)
    assert spec == (None, "model", "data", None)


def test_param_spec_divisibility_fallback():
    # out dim 100 not divisible by 16 -> replicated on that dim
    spec = S.param_spec("head/w", FakeLeaf((1024, 100)), FAKE, RULES)
    assert spec == ("data", None)


def test_param_spec_1d_replicated():
    assert S.param_spec("groups/0/b0/norm1", FakeLeaf((28, 1024)),
                        FAKE, RULES) == ()


def test_cache_spec_kv_and_state():
    assert S.cache_spec("groups/0/b0/k", FakeLeaf((28, 128, 32768, 8, 128)),
                        FAKE, RULES) == (None, "data", "model", None, None)
    assert S.cache_spec("groups/0/b0/slot_pos", FakeLeaf((32768,)),
                        FAKE, RULES) == ()
    # conv cache: channel dim over model
    assert S.cache_spec("groups/0/b0/conv", FakeLeaf((48, 128, 3, 3328)),
                        FAKE, RULES) == (None, "data", None, "model")
    # batch=1 (long_500k): batch falls back to replicated
    assert S.cache_spec("groups/0/b0/k", FakeLeaf((28, 1, 4096, 8, 128)),
                        FAKE, RULES) == (None, None, "model", None, None)


# ------------------------------------------------ shape-only parameters

@pytest.mark.parametrize("name", CONFIGS)
def test_shape_only_init_is_inits_tree(abstract, name):
    model = Model(get_config(name, reduced=True))
    real = _port_leaves(model.init(torch.Generator().manual_seed(0)))
    meta = _port_leaves(model.init(SHAPE_ONLY))
    _same_shapes(meta, real)
    assert all(t.is_meta for t in meta.values())
    # at full size: JAX's abstract tree, and nothing behind any leaf
    params, jparams = abstract[name]
    full = _port_leaves(params)
    _same_shapes(full, _jax_leaves(jparams))
    assert all(t.is_meta for t in full.values())


@pytest.fixture(scope="module")
def jax_param_counts():
    """The JAX dry run's ``_param_counts``.  Importing its module sets
    ``XLA_FLAGS`` for 512 host devices, which must not reach this process's
    backend or its children: the backend starts first, the flag is put
    back after."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _param_counts
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return _param_counts


@pytest.mark.parametrize("name", CONFIGS)
def test_param_counts_equal_jax(jax_param_counts, name):
    got = dryrun._param_counts(Model(get_config(name)))
    assert got == jax_param_counts(JModel(jax_config(name)))
    assert got["active"] <= got["total"]
