"""The plain reference against the port on the CPU at reduced sizes:
Prop 3.6's constants, the event schedule, the models' losses and
gradients (ResNet-8, Qwen3-0.6B's reduced config) and three rounds of
Algorithm 1 against the port's engine replay."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import tree
from perfbench.conftest import HERE
from perfbench.models import resnet, transformer
from perfbench.reference import replay
from perfbench.reference import resnet as ref_resnet
from perfbench.reference import transformer as ref_lm
from perfbench.streams import cifar, schedule, tokens
from repro_torch.core.a2cid2 import params_from_graph
from repro_torch.core.events import Schedule, make_schedule
from repro_torch.core.graphs import build_graph
from repro_torch.core.simulator import Simulator

CPU = torch.device("cpu")
RESNET8 = {"arch": "resnet", "name": "resnet8", "stage_sizes": [1, 1, 1],
           "width": 16, "num_classes": 10, "groups": 4, "image_size": 32,
           "channels": 3, "dtype": "float32"}


def qwen3_reduced() -> dict:
    """The port's ``qwen3_0_6b.reduced()`` in the benchmark's keys."""
    from repro_torch.configs import get_config
    c = get_config("qwen3-0.6b", reduced=True)
    return {"arch": "transformer", "name": c.name, "hidden_size": c.d_model,
            "num_attention_heads": c.num_heads,
            "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim,
            "intermediate_size": c.d_ff, "num_hidden_layers": c.num_layers,
            "vocab_size": c.vocab_size, "rope_theta": c.rope_theta,
            "rms_norm_eps": c.norm_eps, "qk_norm": c.qk_norm,
            "hidden_act": c.mlp_act, "tie_word_embeddings": True,
            "dtype": "float32"}


@pytest.mark.parametrize("graph,n", [("ring", 16), ("ring", 4),
                                     ("ring", 2), ("complete", 6),
                                     ("exponential", 8)])
def test_prop36_is_the_ports(graph, n):
    mine = replay.prop36(*schedule.graph_edges(graph, n), n, True)
    port = params_from_graph(build_graph(graph, n), accelerated=True)
    assert mine == pytest.approx((port.eta, port.alpha, port.alpha_tilde),
                                 rel=1e-12)
    assert replay.prop36(*schedule.graph_edges(graph, n), n, False) == \
        (0.0, 0.5, 0.5)


@pytest.mark.parametrize("n,c", [(16, 1.0), (4, 2.0)])
def test_schedule_is_the_ports_sampler(n, c):
    mine = schedule.sample("ring", n, 12, c, np.random.default_rng(5))
    port = make_schedule(build_graph("ring", n), 12, c, seed=5)
    for key in ("partners", "event_times", "event_mask", "grad_times"):
        np.testing.assert_array_equal(mine[key], getattr(port, key))


def _port_grads(grad_fn, params, stream, n):
    stacked = {p: a.expand((n,) + a.shape).clone()
               for p, a in tree.leaves(params)}
    x = tree.rebuild(params, stacked)
    losses, grads = grad_fn(x, None, torch.arange(n))
    return losses, dict(tree.leaves(grads))


@pytest.mark.parametrize("kind", ["resnet8", "qwen3_reduced"])
def test_reference_model_is_the_ports(kind):
    if kind == "resnet8":
        cfg, arch, ref = RESNET8, resnet, ref_resnet
        wl = {"traffic": {"workers": 2, "batch": 3},
              "stream": {"noise": 0.6}}
        stream = cifar.Stream(cfg, wl, 7, CPU)
    else:
        cfg, arch, ref = qwen3_reduced(), transformer, ref_lm
        wl = {"traffic": {"workers": 2, "batch": 2, "seq": 16},
              "stream": {"copy_p": 0.5}}
        stream = tokens.Stream(cfg, wl, 7, CPU)
    params = arch.init_params(cfg, 3, CPU)
    losses, grads = _port_grads(arch.program_grad_fn(cfg, stream), params,
                                stream, 2)
    batch = stream.batch(0)
    for w in range(2):
        leaves = {p: a.detach().clone().requires_grad_()
                  for p, a in tree.leaves(params)}
        loss = ref.loss(tree.rebuild(params, leaves), cfg,
                        {k: v[w] for k, v in batch.items()})
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True, materialize_grads=True)
        assert float(loss.detach()) == pytest.approx(float(losses[w]),
                                                     rel=1e-6)
        top = max(float(g.abs().max()) for g in gs)
        for (path, _), g in zip(leaves.items(), gs):
            torch.testing.assert_close(grads[path][w], g, rtol=0,
                                       atol=1e-5 * top)


def test_reference_replay_is_the_ports_engine():
    cfg = RESNET8
    wl = {"traffic": {"workers": 4, "batch": 2}, "stream": {"noise": 0.6}}
    stream = cifar.Stream(cfg, wl, 11, CPU)
    arrays = schedule.sample("ring", 4, 3, 2.0, np.random.default_rng(2))
    graph = build_graph("ring", 4)
    sim = Simulator(resnet.program_grad_fn(cfg, stream),
                    params_from_graph(graph), 0.05, device=CPU)
    x0 = resnet.init_params(cfg, 5, CPU)
    state = sim.init(x0, 4, torch.Generator())
    state, tr = sim.run_schedule(state, Schedule(
        arrays["partners"], arrays["event_times"], arrays["event_mask"],
        arrays["grad_times"]))
    dyn = replay.prop36(*schedule.graph_edges("ring", 4), 4, True)
    ref = replay.replay(x0, arrays, dyn, 0.05,
                        lambda p, b: ref_resnet.loss(p, cfg, b),
                        stream.batch)
    np.testing.assert_allclose(tr.loss.numpy(), ref["loss"], rtol=1e-6)
    x0_leaves = dict(tree.leaves(x0))
    for key, buf in (("change_x", state.x), ("change_xt", state.x_tilde)):
        for path, a in tree.leaves(buf):
            got = np.array([float((a[w] - x0_leaves[path]).double().norm())
                            for w in range(4)])
            np.testing.assert_allclose(got, ref[key][path], rtol=1e-3,
                                       atol=1e-7)


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text and "import jax" not in text
