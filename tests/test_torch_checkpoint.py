"""Port parity for checkpoints (``checkpoint/``): the port's MessagePack
codec writes the bytes ``msgpack.packb(payload, use_bin_type=True)``
writes and reads them back as ``msgpack.unpackb(raw=False)`` does, and
checkpoints cross between the packages both ways (a JAX ``TrainState``
into the port through ``convert``, the port's into JAX's ``load_pytree``),
f32 and bf16 leaves alike; retention, ``restore``'s step choice and the
loaders' errors follow the JAX package's.

Tolerance: none — every byte and every leaf exactly equal.  ``msgpack`` is
imported here only: the port itself never imports it.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load_pytree
from repro.checkpoint import restore as j_restore
from repro.checkpoint import save as j_save
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.launch.steps import TrainState as JTrainState
from repro.models import Model as JModel
from repro.optim import sgd as j_sgd
from repro_torch.checkpoint import load_pytree, restore, save, save_pytree
from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.steps import TrainState
from repro_torch.optim import OptState

OBJECTS = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
           2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
           -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, "", "a" * 31,
           "a" * 32, "é" * 200, "x" * 70000, b"", b"ab" * 200,
           b"z" * 70000, bytearray(b"q" * 300), [], [1] * 15, [1] * 16,
           list(range(70000)), (1, "two", b"3"), {},
           {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
           {str(i): {"k": None} for i in range(70000)}]


@pytest.mark.parametrize("obj", OBJECTS,
                         ids=[f"{type(o).__name__}{i}"
                              for i, o in enumerate(OBJECTS)])
def test_codec_bytes_equal_msgpack(obj):
    data = packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert unpackb(data) == msgpack.unpackb(data, raw=False)


def test_codec_refuses_what_it_does_not_cover():
    for obj in (1.5, 2 ** 64, -2 ** 63 - 1, object()):
        with pytest.raises((TypeError, OverflowError)):
            packb(obj)
    with pytest.raises(ValueError, match="not covered"):
        unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="extra data"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb("abc")[:-1])


def _jax_state(dtype=jnp.float32):
    model = JModel(j_get_config("nano-lm", reduced=True))
    params = jax.tree.map(lambda a: a.astype(dtype),
                          model.init(jax.random.PRNGKey(0)))
    opt = j_sgd().init(params)
    # a momentum that is not zero, so the comparison reads real bits
    opt = opt._replace(mu=jax.tree.map(lambda a: a + 0.25, opt.mu),
                       step=opt.step + 7)
    return JTrainState(params, opt)


def _leaves(tree):
    """Tensor leaves (``core.tree`` keeps None as a leaf; the checkpoint
    format, as JAX, holds none for it)."""
    return [t for t in tree_leaves(tree) if t is not None]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_checkpoint_loads_into_the_port(tmp_path, dtype):
    jstate = _jax_state(dtype)
    j_save(str(tmp_path), 3, jstate)
    want = train_state_from_jax(jax.device_get(jstate), device="cpu")
    like = TrainState(jax.tree.map(torch.zeros_like, want.params),
                      OptState(torch.zeros_like(want.opt.step),
                               jax.tree.map(torch.zeros_like, want.opt.mu),
                               None))
    step, got = restore(str(tmp_path), like)
    assert step == 3 and type(got) is TrainState
    assert type(got.opt) is OptState and got.opt.nu is None
    _equal_trees(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_checkpoint_loads_into_jax(tmp_path, dtype):
    jstate = _jax_state(dtype)
    state = train_state_from_jax(jax.device_get(jstate), device="cpu")
    path = str(tmp_path / "state.msgpack")
    save_pytree(path, state)
    with open(path, "rb") as f:
        data = f.read()
    payload = msgpack.unpackb(data, raw=False)
    assert data == msgpack.packb(payload, use_bin_type=True)
    assert payload["treedef"].startswith("TrainState(params={")
    zeros = jax.tree.map(jnp.zeros_like, jstate)
    back = j_load_pytree(path, zeros)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and a JAX-written file of the same tree holds the same leaves
    j_save_pytree(str(tmp_path / "jax.msgpack"), jstate)
    with open(tmp_path / "jax.msgpack", "rb") as f:
        jpayload = msgpack.unpackb(f.read(), raw=False)
    assert jpayload["leaves"] == payload["leaves"]


def test_bf16_tree_round_trips_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=gen).bfloat16(),
            "b": [torch.randn(7, generator=gen).bfloat16(),
                  torch.arange(4, dtype=torch.int32)],
            "none": None, "t": (torch.tensor(2.5, dtype=torch.float64),)}
    tree["w"][0, 0] = float("nan")
    tree["w"][0, 1] = -0.0
    save_pytree(str(tmp_path / "a.msgpack"), tree)
    back = load_pytree(str(tmp_path / "a.msgpack"), tree)
    assert back["none"] is None and isinstance(back["t"], tuple)
    assert len(_leaves(back)) == len(_leaves(tree)) == 4
    for a, b in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b)
    # a loaded leaf takes the dtype of the matching leaf of ``like``
    like = {**tree, "w": tree["w"].float()}
    assert load_pytree(str(tmp_path / "a.msgpack"), like)["w"].dtype == \
        torch.float32


def test_retention_and_restore_follow_jax(tmp_path):
    tree = {"x": torch.arange(6.0).reshape(2, 3)}
    jtree = {"x": jnp.arange(6.0).reshape(2, 3)}
    for step in (1, 5, 2, 9, 4):
        path = save(str(tmp_path / "port"), step,
                    {"x": tree["x"] + step})
        assert os.path.exists(path)
        j_save(str(tmp_path / "jax"), step, {"x": jtree["x"] + step})
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == sorted(os.listdir(tmp_path / "jax"))
    assert kept == ["step_00000004", "step_00000005", "step_00000009"]
    step, got = restore(str(tmp_path / "port"), tree)
    jstep, jgot = j_restore(str(tmp_path / "port"), jtree)
    assert step == jstep == 9
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(jgot["x"]))
    step, got = restore(str(tmp_path / "jax"), tree, step=5)
    assert step == 5 and torch.equal(got["x"], tree["x"] + 5)
    assert not [f for f in os.listdir(tmp_path / "port" / kept[0])
                if f != "state.msgpack"]   # no temporary file left
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "port" / kept[0]), tree)


def test_loader_errors_match_jax(tmp_path):
    path = str(tmp_path / "s.msgpack")
    save_pytree(path, {"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    cases = [({"a": torch.zeros(3, 2), "b": torch.zeros(4)},
              {"a": jnp.zeros((3, 2)), "b": jnp.zeros(4)}),
             ({"a": torch.zeros(2, 3)}, {"a": jnp.zeros((2, 3))})]
    for like, jlike in cases:
        with pytest.raises(ValueError) as terr:
            load_pytree(path, like)
        with pytest.raises(ValueError) as jerr:
            j_load_pytree(path, jlike)
        assert str(terr.value) == str(jerr.value)


def test_loaded_leaves_go_to_the_like_device_and_params_convert(tmp_path):
    jp = jax.device_get(JModel(j_get_config("nano-lm", reduced=True)).init(
        jax.random.PRNGKey(1)))
    j_save_pytree(str(tmp_path / "p.msgpack"), jp)
    like = params_from_jax(jax.tree.map(np.zeros_like, jp), device="cpu")
    got = load_pytree(str(tmp_path / "p.msgpack"), like)
    _equal_trees(got, params_from_jax(jp, device="cpu"))
    assert all(a.device.type == "cpu" for a in tree_leaves(got))
