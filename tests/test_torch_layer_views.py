"""How ``Model.forward`` hands a group's stacked weights to its layers:
each leaf unbound along its layer axis once a forward, so that the
backward writes each leaf's gradient with one ``stack`` of its layers'
gradients, where a slice ``a[r]`` a layer gives a zero-filled full
gradient a layer and a running sum.

On a nano LM with one group of 3 layers and on the reduced ``mla_moe``
layout (a dense group of 1 layer, a MoE group of 2): ``lm_grad_fn``'s
losses and gradients (without remat) and the synchronous step's (with
it) bit for bit those of the same model with a slice a layer (written
below); no ``select_backward`` of a stacked leaf's shape, where the
sliced model has one a leaf and layer, and one ``stack`` per stacked
leaf that gets a gradient; and the ``model.layers`` counter, once a
forward under an active tracer and never without one."""
import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from perfbench.conftest import HERE
from perfbench.models import mla_moe
from repro_torch.analysis import SpanTracer
from repro_torch.configs import nano_lm
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from repro_torch.launch.steps import _value_and_grad
from repro_torch.models.config import Block, uniform_blocks
from repro_torch.models.layers import apply_lm_head, embed_inputs, rmsnorm
from repro_torch.models.transformer import Model, apply_block, lm_grad_fn

CPU = torch.device("cpu")
W, B, S = 3, 1, 16
MLA_MOE = dict(hidden_size=128, num_attention_heads=4, kv_lora_rank=32,
               qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
               intermediate_size=256, moe_intermediate_size=32,
               router_experts=16, n_routed_experts=4, num_experts_per_tok=4,
               vocab_size=300, num_hidden_layers=3)


def _nano():
    cfg = dataclasses.replace(
        nano_lm.reduced(), blocks=uniform_blocks(Block("attn", "dense"), 3))
    gen = torch.Generator().manual_seed(11)
    return cfg, Model(cfg).init(gen)


def _mla_moe():
    raw = json.loads((HERE / "configs/kanana2_30b_a3b.json").read_text())
    raw.update(MLA_MOE)
    return mla_moe.model_config(raw), mla_moe.init_params(raw, 5, CPU)


LAYOUTS = {"nano": _nano, "mla_moe": _mla_moe}
REPEATS = {"nano": [3], "mla_moe": [1, 2]}   # layers a group
# (stacked leaves, layer views): a nano layer's 9 leaves x 3; the MLA
# layer's 6, 2 norms, the dense MLP's 3 (x 1) and the MoE's 8 (x 2)
COUNTS = {"nano": (9, 27), "mla_moe": (27, 43)}


class Sliced(Model):
    """``Model.forward`` with each layer's weights taken as ``a[r]``."""

    def forward(self, params, inputs, *, remat=False):
        cfg = self.cfg
        x = embed_inputs(params["embed"], cfg, inputs)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32)
        for (unit, repeat), group_p in zip(cfg.blocks, params["groups"]):

            def unit_fn(x, layer_p, unit=unit):
                aux = torch.zeros((), dtype=torch.float32)
                for i, blk in enumerate(unit):
                    x, a = apply_block(layer_p[f"b{i}"], cfg, blk, x,
                                       positions)
                    aux = aux + a
                return x, aux

            auxs = []
            for r in range(repeat):
                layer_p = tree_map(lambda a, r=r: a[r], group_p)
                if remat:
                    x, aux = checkpoint(unit_fn, x, layer_p,
                                        use_reentrant=False)
                else:
                    x, aux = unit_fn(x, layer_p)
                auxs.append(aux)
            aux_total = aux_total + torch.stack(auxs).sum()
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return apply_lm_head(params["head"], params["embed"], cfg, x), \
            aux_total, x


class _Fixed:
    """A stream of one fixed batch a worker."""

    def __init__(self, cfg, seed=3):
        gen = torch.Generator().manual_seed(seed)
        self.batch = {k: torch.randint(0, cfg.vocab_size, (W, B, S),
                                       generator=gen)
                      for k in ("inputs", "labels")}

    def sample_workers(self, generator, n):
        return {k: v[:n] for k, v in self.batch.items()}


class _Ops(TorchDispatchMode):
    """Records each op: (op, the autograd node running it or None, its
    result's shape)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        node = torch._C._current_autograd_node()
        self.ops.append((func.overloadpacket,
                         None if node is None else node.name(),
                         tuple(out.shape) if isinstance(out, torch.Tensor)
                         else None))
        return out


def _workers(params):
    """Each leaf stacked over W workers, each worker's a little apart."""
    gen = torch.Generator().manual_seed(0)
    return tree_map(lambda a: a.expand((W,) + a.shape) + 1e-3 * torch.randn(
        (W,) + a.shape, generator=gen, dtype=a.dtype), params)


def _group_leaves(stacked):
    """(path, leaf) of every layer-stacked leaf."""
    leaves, _ = tree_flatten_with_path(stacked["groups"])
    return leaves


def _grads(model, params, stream, remat):
    """(losses, grads): without remat ``lm_grad_fn`` over W workers;
    with it the synchronous step's, on worker 0 (``torch.utils.checkpoint``
    under ``lm_grad_fn``'s vmap raises, the sliced forward's as well: its
    saved-tensor hooks run outside the vmap)."""
    if not remat:
        return lm_grad_fn(model, stream)(params, None, torch.arange(W))
    batch = {k: v[0] for k, v in stream.batch.items()}
    (loss, _), grads = _value_and_grad(model, params, batch, remat=True)
    return loss, grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grads_are_the_sliced_forwards_with_one_stack_a_leaf(layout, remat):
    cfg, params = LAYOUTS[layout]()
    assert sorted(r for _, r in cfg.blocks) == REPEATS[layout]
    stacked, stream = _workers(params), _Fixed(cfg)
    if remat:
        stacked = tree_map(lambda a: a[0].clone(), stacked)
    with _Ops() as mode:
        losses, grads = _grads(Model(cfg), stacked, stream, remat)
    with _Ops() as control:
        want_losses, want = _grads(Sliced(cfg), stacked, stream, remat)
    assert torch.equal(losses, want_losses)
    got_l, _ = tree_flatten_with_path(grads)
    want_l, _ = tree_flatten_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.shape == w.shape and torch.equal(g, w), path

    # the backward: no slice gradient of a stacked leaf (the sliced
    # forward's backward has one a leaf and layer), one stack a stacked
    # leaf that gets a gradient
    graded = [(path, leaf) for path, leaf in _group_leaves(stacked)
              if path[-1].key != "router_bias"]
    shapes = {tuple(a.shape) for _, a in graded}

    def slice_grads(ops):
        return [shape for op, _, shape in ops
                if op is torch.ops.aten.select_backward and shape in shapes]
    reps = [r for _, r in cfg.blocks]
    assert len(slice_grads(control.ops)) \
        == sum(reps[path[0].idx] for path, _ in graded)
    assert not slice_grads(mode.ops)
    stacks = [shape for op, node, shape in mode.ops
              if op is torch.ops.aten.stack and node is not None
              and node.startswith("Unbind")]
    assert sorted(stacks) == sorted(tuple(a.shape) for _, a in graded)
    # the router's selection bias is differentiated by no layer
    for path, g in _group_leaves(grads):
        if path[-1].key == "router_bias":
            assert not g.any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layers_counter_once_a_forward(layout):
    cfg, params = LAYOUTS[layout]()
    model = Model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    leaves, slices = COUNTS[layout]
    assert len(_group_leaves(params)) == leaves

    tracer = SpanTracer("t")
    model.forward(params, tokens)                  # none active: nothing
    assert not [e for e in tracer.events if e["ph"] == "C"]
    with tracer.activate():
        model.forward(params, tokens)
    samples = [e for e in tracer.events
               if e["ph"] == "C" and e["name"] == "model.layers"]
    assert len(samples) == 1
    assert samples[0]["args"] == {"leaves": leaves, "slices": slices}
