"""Port parity: the flat-buffer layout of ``repro_torch.core.flatbuf``
places every leaf where the JAX package does, packs bitwise the same
buffers, and round-trips exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FlatGossipEngine as JEngine
from repro.core import FlatLayout as JLayout
from repro.core import baseline_params as j_baseline
from repro.models.resnet import init_resnet as j_init_resnet
from repro.models.resnet import resnet8_cifar as j_resnet8
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.flatbuf import LANE, FlatLayout
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map


def _stacked_np(tree, w, seed=0):
    """Worker-stacked numpy copy of a JAX tree with distinct rows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a)[None]
                   + rng.normal(size=(w,) + a.shape)).astype(a.dtype), tree)


@pytest.fixture(scope="module")
def resnet8_stacked():
    params = jax.device_get(j_init_resnet(jax.random.PRNGKey(0),
                                          j_resnet8()))
    return _stacked_np(params, 3)


def test_leaf_order_matches_jax_sorted_keys(resnet8_stacked):
    t_tree = params_from_jax(resnet8_stacked, device="cpu")
    # insertion order would start with "stem"; JAX sorts keys: head first
    assert list(t_tree) == ["head", "stages", "stem", "stem_gn"]
    for a, b in zip(jax.tree.leaves(resnet8_stacked), tree_leaves(t_tree)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


def test_layout_offsets_and_width_equal_jax(resnet8_stacked):
    jl = JLayout.from_pytree(resnet8_stacked, stacked=True)
    tl = FlatLayout.from_pytree(params_from_jax(resnet8_stacked,
                                                device="cpu"), stacked=True)
    assert (tl.d, tl.d_real) == (jl.d, jl.d_real) and tl.d % LANE == 0
    assert [(s.offset, s.size, s.shape) for s in tl.specs] == \
        [(s.offset, s.size, s.shape) for s in jl.specs]
    assert tl.buf_dtype == torch.float32


def test_pack_bitwise_equals_jax_engine_pack(resnet8_stacked):
    jeng = JEngine.for_pytree(resnet8_stacked, j_baseline(1.0),
                              backend="ref")
    jbuf = np.asarray(jeng.pack(jax.tree.map(jnp.asarray, resnet8_stacked)))
    t_tree = params_from_jax(resnet8_stacked, device="cpu")
    tl = FlatLayout.from_pytree(t_tree, stacked=True)
    tbuf = tl.pack(t_tree)
    np.testing.assert_array_equal(jbuf, tbuf.numpy())
    # round trip: bitwise, through the port and back to numpy
    back = params_to_numpy(tl.unpack(tbuf))
    for a, b in zip(jax.tree.leaves(resnet8_stacked), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _mixed_tree(w=None):
    g = torch.Generator().manual_seed(0)

    def leaf(shape, dtype):
        s = ((w,) + shape) if w else shape
        return torch.randn(s, generator=g).to(dtype)

    return {"dense": {"w": leaf((7, 5), torch.float32),
                      "b": leaf((5,), torch.bfloat16)},
            "scale": leaf((), torch.float32),
            "embed": [leaf((11, 3), torch.float16),
                      leaf((130,), torch.float32)]}


@pytest.mark.parametrize("stacked", [False, True])
def test_mixed_dtypes_pack_as_f32_and_round_trip(stacked):
    tree = _mixed_tree(w=4 if stacked else None)
    layout = FlatLayout.from_pytree(tree, stacked=stacked)
    assert layout.buf_dtype == torch.float32
    buf = layout.pack(tree) if stacked else layout.pack_local(tree)
    out = layout.unpack(buf) if stacked else layout.unpack_local(buf)
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    flat = buf if buf.dim() == 1 else buf[0]
    assert torch.all(flat[layout.d_real:] == 0)
    # the JAX layout of the same tree agrees on every offset
    jtree = jax.tree.map(lambda a: jnp.asarray(a.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
         torch.float16: jnp.float16}[a.dtype]), tree,
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    jl = JLayout.from_pytree(jtree, stacked=stacked)
    assert [s.offset for s in jl.specs] == [s.offset for s in layout.specs]
    assert jl.d == layout.d


def test_uniform_bf16_packs_natively():
    tree = tree_map(lambda a: a.to(torch.bfloat16), _mixed_tree(w=2))
    layout = FlatLayout.from_pytree(tree, stacked=True)
    assert layout.buf_dtype == torch.bfloat16
    out = layout.unpack(layout.pack(tree))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tree), tree_leaves(out)))


def test_int_leaves_raise_type_error():
    with pytest.raises(TypeError):
        FlatLayout.from_pytree({"i": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(TypeError):
        FlatLayout.from_pytree({"a": torch.zeros(3),
                                "i": torch.zeros(3, dtype=torch.int64)})


def test_treedef_round_trip_keeps_containers():
    tree = {"b": (torch.ones(1), [torch.zeros(2)]), "a": torch.ones(3)}
    leaves, td = tree_flatten(tree)
    assert [tuple(x.shape) for x in leaves] == [(3,), (1,), (2,)]
    back = td.unflatten(leaves)
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
    with pytest.raises(ValueError):
        td.unflatten(leaves[:2])
    with pytest.raises(ValueError):
        td.flatten_up_to({"a": leaves[0], "c": leaves[1]})
