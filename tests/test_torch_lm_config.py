"""Port parity for the transformer family's configuration and init: every
``get_config(name, reduced)`` equals the JAX package's field for field, and
``Model.init`` builds the JAX tree (structure, shapes, dtypes, leaf order:
a list of groups, stacked leaves, an empty ``"head"`` when tied), which
``convert`` and ``FlatLayout`` carry as the JAX package does.  Every
config builds, the four that once raised (MLA, SSD, RG-LRU, MoE + dense)
and a MoE block or multi-token prediction on nano-lm included, and runs a
finite reduced forward of the right shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as J_ARCHITECTURES
from repro.configs import get_config as j_get_config
from repro.core.flatbuf import FlatLayout as JFlatLayout
from repro.models import Model as JModel
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.flatbuf import FlatLayout
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.models.config import Block, MoEConfig, uniform_blocks
from repro_torch.models.transformer import Model

from port_parity import as_jax_fields


def test_architecture_list_matches_jax():
    assert ARCHITECTURES == J_ARCHITECTURES


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", J_ARCHITECTURES + ("nano-lm",))
def test_config_equals_jax(name, reduced):
    tc, jc = get_config(name, reduced), j_get_config(name, reduced)
    assert as_jax_fields(tc) == dataclasses.asdict(jc)
    assert (tc.num_layers, tc.resolved_head_dim, tc.padded_vocab) == \
        (jc.num_layers, jc.resolved_head_dim, jc.padded_vocab)
    assert as_jax_fields(tc.windowed(32)) == \
        dataclasses.asdict(jc.windowed(32))


def test_train_bench_config_equals_jax():
    from repro.configs.nano_lm import train_bench as j_bench
    from repro_torch.configs.nano_lm import train_bench
    assert dataclasses.asdict(train_bench()) == dataclasses.asdict(j_bench())


@pytest.mark.parametrize("name", ["nano-lm", "qwen3-0.6b",
                                  "deepseek-v3-671b", "arctic-480b",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_init_tree_matches_jax(name):
    jm = JModel(j_get_config(name, reduced=True))
    tm = Model(get_config(name, reduced=True))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tp = tm.init(torch.Generator().manual_seed(0))
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = tree_flatten(tp)
    assert [(a.shape, np.dtype(a.dtype)) for a in jl] == \
        [(tuple(b.shape), b.numpy().dtype) for b in tl]
    assert isinstance(tp["groups"], list)
    assert (tp["head"] == {}) == tm.cfg.tie_embeddings
    assert tm.param_count(tp) == sum(int(np.prod(a.shape)) for a in jl)
    # the same weights through convert: the port's tree, value for value
    jw = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    carried = params_from_jax(jw, device="cpu")
    assert tree_flatten(carried)[1] == tdef
    for a, b in zip(jax.tree.leaves(jw), tree_leaves(carried)):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(jax.tree.leaves(jw),
                    jax.tree.leaves(params_to_numpy(carried))):
        np.testing.assert_array_equal(a, b)
    # the flat buffer of a worker-stacked tree, column for column
    stack = jax.tree.map(lambda a: jnp.stack([a, 2 * a]), jw)
    jlay = JFlatLayout.from_pytree(stack, stacked=True)
    tlay = FlatLayout.from_pytree(params_from_jax(
        jax.device_get(stack), device="cpu"), stacked=True)
    assert (tlay.d, tlay.d_real) == (jlay.d, jlay.d_real)
    np.testing.assert_array_equal(
        tlay.pack(params_from_jax(jax.device_get(stack), device="cpu"))
        .numpy(), np.asarray(jlay.pack(stack)))


def test_init_draws_from_the_generator():
    cfg = get_config("nano-lm", reduced=True)
    a = Model(cfg).init(torch.Generator().manual_seed(0))
    b = Model(cfg).init(torch.Generator().manual_seed(0))
    c = Model(cfg).init(torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    wq = a["groups"][0]["b0"]["mixer"]["wq"]
    assert not torch.equal(wq, c["groups"][0]["b0"]["mixer"]["wq"])
    # truncated normal on [-2, 2] / sqrt(fan_in); the embeddings 0.02 N(0,1)
    assert wq.abs().max() <= 2.0 / np.sqrt(cfg.d_model)
    assert abs(a["embed"]["tok"].std().item() - 0.02) < 2e-3
    assert all(torch.equal(x, torch.zeros_like(x))
               for x in (a["final_norm"], a["groups"][0]["b0"]["norm1"]))


def _forward_runs(cfg, s=8):
    """``cfg`` builds, and its forward on 2 x ``s`` tokens is finite with
    the right shapes; the loss has the JAX package's metrics."""
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, s + 1),
                         generator=torch.Generator().manual_seed(1))
    logits, aux, h = model.forward(params, toks[:, :-1])
    assert tuple(logits.shape) == (2, s, cfg.padded_vocab)
    assert tuple(h.shape) == (2, s, cfg.d_model)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (aux.item() > 0) == any(b.mlp.startswith("moe")
                                   for b in cfg.all_blocks())
    loss, metrics = model.loss(params, {"inputs": toks[:, :-1],
                                        "labels": toks[:, 1:]})
    assert bool(torch.isfinite(loss))
    assert set(metrics) == ({"ce", "aux", "mtp"} if cfg.mtp
                            else {"ce", "aux"})


@pytest.mark.parametrize("name,what", [
    ("deepseek-v3-671b", "mla"), ("mamba2-780m", "ssd"),
    ("recurrentgemma-9b", "rglru"), ("arctic-480b", "moe+dense"),
])
def test_former_refusals_build_and_run(name, what):
    """The parts the port once refused (``check_ported``) build and run."""
    cfg = get_config(name, reduced=True)
    assert any(what in (b.mixer, b.mlp) for b in cfg.all_blocks())
    _forward_runs(cfg, s=cfg.ssm.chunk if cfg.ssm else 8)


def test_moe_and_mtp_on_nano_lm_build_and_run():
    cfg = get_config("nano-lm", reduced=True)
    _forward_runs(cfg.with_updates(
        blocks=uniform_blocks(Block("attn", "moe"), 2),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64)))
    _forward_runs(cfg.with_updates(mtp=True))


def test_validate_raises():
    cfg = get_config("nano-lm", reduced=True)
    with pytest.raises(ValueError, match="KV groups"):
        cfg.with_updates(num_kv_heads=3).validate()
    with pytest.raises(ValueError, match="sub-config"):
        cfg.with_updates(blocks=uniform_blocks(Block("ssd", "none"),
                                               1)).validate()
