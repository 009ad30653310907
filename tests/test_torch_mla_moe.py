"""Kanana-2-30B-A3B's DeepSeek-V3 block in the port, against the
benchmark's plain reference (``perfbench/reference/mla_moe.py``) on the
CPU at a small size (d 256, 4 heads, MLA rank 32 / rope 16 / nope and v
32 without q-LoRA, 16 experts, top-4, 4 held): the loss and every leaf's
gradient under ``vmap`` over 2 workers; dropless routing with every token
on one expert, which a capacity would drop; selection by the biased
scores with gates from the unbiased ones; the expert-parallel share (the
four shares' outputs, the shared expert counted once, add up to the uncut
layer's); MLA without q-LoRA in decode; one ``Simulator.run_schedule``
call against the reference's Algorithm 1.  The output check's router
hold: the program's picks of the check's ticks ride the stream's
batches, and the reference takes them at near ties only."""
import copy
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import tree
from perfbench.conftest import HERE, ROOT
from perfbench.models import mla_moe
from perfbench.reference import mla_moe as ref
from perfbench.reference import replay
from perfbench.streams import schedule, tokens
from repro_torch.core.a2cid2 import params_from_graph
from repro_torch.core.events import Schedule
from repro_torch.core.graphs import build_graph
from repro_torch.core.simulator import Simulator
from repro_torch.models import layers
from repro_torch.models.transformer import Model

CPU = torch.device("cpu")
SMALL = dict(hidden_size=256, num_attention_heads=4, kv_lora_rank=32,
             qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
             intermediate_size=512, moe_intermediate_size=64,
             router_experts=16, n_routed_experts=4, num_experts_per_tok=4,
             vocab_size=500, num_hidden_layers=3)


def small_cfg(**kw) -> dict:
    cfg = json.loads((HERE / "configs/kanana2_30b_a3b.json").read_text())
    cfg.update(SMALL, **kw)
    return cfg


def _stream(cfg, workers=2, seq=16, seed=7):
    wl = {"traffic": {"workers": workers, "batch": 1, "seq": seq},
          "stream": {"copy_p": 0.5}}
    return tokens.Stream(cfg, wl, seed, CPU)


def _port(cfg, params, stream, n):
    stacked = {p: a.expand((n,) + a.shape).clone()
               for p, a in tree.leaves(params)}
    losses, grads = mla_moe.program_grad_fn(cfg, stream)(
        tree.rebuild(params, stacked), None, torch.arange(n))
    return losses, dict(tree.leaves(grads))


def _reference(cfg, params, batch, fault=None):
    leaves = {p: a.detach().clone().requires_grad_()
              for p, a in tree.leaves(params)}
    loss = ref.loss(tree.rebuild(params, leaves), cfg, batch, fault)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    return float(loss.detach()), dict(zip(leaves, gs))


def _held_to(params, cfg, losses, grads, stream, n=2):
    batch = stream.batch(0)
    for w in range(n):
        loss, gs = _reference(cfg, params, {k: v[w] for k, v in
                                            batch.items()})
        assert loss == pytest.approx(float(losses[w]), rel=1e-6)
        top = max(float(g.abs().max()) for g in gs.values())
        for path, g in gs.items():
            torch.testing.assert_close(grads[path][w], g, rtol=0,
                                       atol=1e-5 * top)


def test_tree_is_the_models():
    cfg = small_cfg()
    mine = mla_moe.init_params(cfg, 3, CPU)
    model = Model(mla_moe.model_config(cfg))
    theirs = model.init(torch.Generator().manual_seed(0))
    assert [(p, a.shape) for p, a in tree.leaves(mine)] == \
        [(p, a.shape) for p, a in tree.leaves(theirs)]
    mixer = theirs["groups"][0]["b0"]["mixer"]
    assert "w_q" in mixer and not {"w_dq", "q_norm", "w_uq"} & set(mixer)
    assert theirs["groups"][1]["b0"]["mlp"]["moe_up"].shape[1] == 4
    assert theirs["groups"][1]["b0"]["mlp"]["router"].shape[-1] == 16


def test_loss_and_every_gradient_under_vmap():
    cfg = small_cfg()
    stream = _stream(cfg)
    params = mla_moe.init_params(cfg, 3, CPU)
    losses, grads = _port(cfg, params, stream, 2)
    _held_to(params, cfg, losses, grads, stream)


def test_dropless_with_every_token_on_one_expert():
    """Every token selects held expert 1: its group holds every row, four
    times a 1.25 capacity, and nothing is dropped."""
    cfg = small_cfg()
    stream = _stream(cfg, seq=32)
    params = mla_moe.init_params(cfg, 4, CPU)
    params["groups"][1]["b0"]["mlp"]["router_bias"][:, 1] = 5.0
    losses, grads = _port(cfg, params, stream, 2)
    _held_to(params, cfg, losses, grads, stream)
    # the program's picks are of the sound layers: not handed to a fault
    row = {k: v[0] for k, v in stream.batch(0).items() if k != "picks"}
    dropped, _ = _reference(cfg, params, row, fault="capacity")
    assert abs(dropped - float(losses[0])) > 1e-4


def test_selection_biased_gates_unbiased():
    cfg = small_cfg()
    moe = mla_moe.model_config(cfg).moe
    g = torch.Generator().manual_seed(5)
    p = {"router": torch.randn(256, 16, generator=g) / 16,
         "router_bias": torch.randn(16, generator=g) * 0.1}
    x = torch.randn(1, 64, 256, generator=g)
    _, topw, topi = layers.moe_route(p, x, moe)
    scores = torch.sigmoid(x @ p["router"])
    want_i = torch.sort(scores + p["router_bias"], dim=-1, descending=True,
                        stable=True).indices[..., :4]
    assert torch.equal(topi, want_i)
    # the bias moves the selection of some tokens
    assert not torch.equal(topi, torch.sort(scores, dim=-1,
                                            descending=True).indices[..., :4])
    gate = torch.gather(scores, -1, want_i)
    torch.testing.assert_close(topw, gate / gate.sum(-1, keepdim=True)
                               * 2.448, rtol=1e-6, atol=0)
    ids, gates, _ = ref.route(x[0], p, cfg)
    assert torch.equal(ids, topi[0])
    torch.testing.assert_close(gates, topw[0], rtol=1e-6, atol=0)
    _, biased, _ = ref.route(x[0], p, cfg, fault="biased_gates")
    assert (biased - gates).abs().max() > 1e-3


def test_reference_takes_the_programs_picks_only_at_near_ties():
    """Where the reference's k-th and (k+1)-th biased scores lie within
    ``NEAR_TIE`` it takes the program's picks; a token picked otherwise
    where the margin is clear makes the loss NaN."""
    cfg = small_cfg()
    g = torch.Generator().manual_seed(6)
    p = {"router": torch.randn(256, 16, generator=g) / 16,
         "router_bias": torch.zeros(16)}
    x = torch.randn(32, 256, generator=g)
    scores = torch.sigmoid(x @ p["router"])
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    # token 0's 4th and 5th experts a near tie (5e-6 apart): the program
    # may pick the 5th
    p["router_bias"][order[0, 4]] = float(
        scores[0, order[0, 3]] - scores[0, order[0, 4]]) - 5e-6
    own, _, _ = ref.route(x, p, cfg)
    swapped = own.clone()
    swapped[0, 3] = order[0, 4]
    ids, gates, missed = ref.route(x, p, cfg, program=swapped)
    assert missed == 0 and torch.equal(ids, swapped)
    want = torch.gather(scores, -1, swapped)
    torch.testing.assert_close(gates, want / want.sum(-1, keepdim=True)
                               * 2.448, rtol=1e-6, atol=0)
    # a clear margin: the program's pick is refused and counted
    clear = own.clone()
    clear[5, 3] = order[5, 15]
    ids, _, missed = ref.route(x, p, cfg, program=clear)
    assert missed == 1 and torch.equal(ids[5], own[5])
    # ... and the loss is NaN
    params = mla_moe.init_params(cfg, 3, CPU)
    row = {k: v[0] for k, v in _stream(cfg).batch(0).items()}
    _port(cfg, params, stream := _stream(cfg), 2)
    picks = stream.batch(0)["picks"][0]
    assert np.isfinite(_reference(cfg, params, dict(row, picks=picks))[0])
    wrong = picks.clone()
    wrong[..., 0] = (wrong[..., 0] + 1) % 16
    assert np.isnan(_reference(cfg, params, dict(row, picks=wrong))[0])


def test_program_picks_ride_the_check_ticks_batches():
    """``program_grad_fn`` keeps its routers' picks in the output check's
    ticks and ``stream.batch`` of those ticks hands them on: (W, B, S,
    MoE layers, K), the port router's top-k of each layer."""
    from perfbench.harness import CHECK_ROUNDS
    cfg = small_cfg()
    stream = _stream(cfg, workers=2, seq=16)
    params = mla_moe.init_params(cfg, 3, CPU)
    grad_fn = mla_moe.program_grad_fn(cfg, stream)
    stacked = tree.rebuild(params, {p: a.expand((2,) + a.shape).clone()
                                    for p, a in tree.leaves(params)})
    for _ in range(CHECK_ROUNDS + 1):
        grad_fn(stacked, None, torch.arange(2))
    for tick in range(CHECK_ROUNDS):
        assert stream.batch(tick)["picks"].shape == (2, 1, 16, 2, 4)
    assert "picks" not in stream.batch(CHECK_ROUNDS)
    # layer 0 of the MoE group: the router on the first MoE layer's input
    model = Model(mla_moe.model_config(cfg))
    moe = mla_moe.model_config(cfg).moe
    seen = {}
    orig = layers.moe_route

    def spy(p, x, c):
        out = orig(p, x, c)
        seen.setdefault("topi", out[2])
        return out

    layers.moe_route = spy
    try:
        model.loss(params, {k: v[1] for k, v in stream.batch(0).items()
                            if k != "picks"})
    finally:
        layers.moe_route = orig
    assert moe.scoring == "sigmoid"
    assert torch.equal(stream.batch(0)["picks"][1, :, :, 0], seen["topi"])


def test_the_shares_add_up_to_the_uncut_layer():
    """Four chips of 4 experts each: their outputs, less the shared expert
    that each adds, plus the shared expert once, are the layer that holds
    all 16."""
    cfg = small_cfg()
    full = mla_moe.model_config(cfg).moe
    whole = dataclasses.replace(full, held=(0, 16))
    g = torch.Generator().manual_seed(8)
    p = layers.init_moe(g, 256, whole, torch.float32)
    p["router_bias"] = torch.randn(16, generator=g) * 0.01
    x = torch.randn(2, 24, 256, generator=g)
    uncut, _ = layers.apply_moe(p, x, whole)
    shared = layers.apply_mlp(p["shared"], x)
    total = shared.clone()
    for share in range(4):
        q = dict(p, **{k: p[k][4 * share:4 * share + 4]
                       for k in ("moe_gate", "moe_up", "moe_down")})
        out, _ = layers.apply_moe(
            q, x, dataclasses.replace(full, held=(4 * share, 4)))
        total = total + (out - shared)
    torch.testing.assert_close(total, uncut, rtol=0,
                               atol=1e-5 * float(uncut.abs().max()))


def test_a_share_refuses_gelu_experts():
    """A held share runs SwiGLU experts only; a layer that holds them all
    (``held`` None) keeps the capacity path and its GELU experts."""
    moe = mla_moe.model_config(small_cfg()).moe
    g = torch.Generator().manual_seed(0)
    p = layers.init_moe(g, 256, moe, torch.float32, act="gelu")
    p["router_bias"] = torch.zeros(16)
    x = torch.zeros(1, 4, 256)
    with pytest.raises(ValueError, match="SwiGLU"):
        layers.apply_moe(p, x, moe, act="gelu")
    whole = dataclasses.replace(moe, held=None)
    p = layers.init_moe(g, 256, whole, torch.float32, act="gelu")
    out, _ = layers.apply_moe(p, x, whole, act="gelu")
    assert out.shape == x.shape


def test_decode_without_q_lora_is_the_forward():
    cfg = small_cfg()
    model = Model(mla_moe.model_config(cfg))
    params = mla_moe.init_params(cfg, 6, CPU)
    tok = _stream(cfg, workers=1, seq=8).batch(0)["inputs"][0]
    logits, _, _ = model.forward(params, tok)
    caches = model.init_cache(1, 8, device="cpu")
    for t in range(8):
        step, caches = model.decode_step(params, tok[:, t:t + 1], t, caches)
        torch.testing.assert_close(step[:, 0], logits[:, t], rtol=0,
                                   atol=2e-4 * float(logits.abs().max()))


def test_replay_is_the_references_algorithm():
    cfg = small_cfg()
    n, gamma = 4, 0.05
    stream = _stream(cfg, workers=n, seq=16, seed=11)
    arrays = schedule.sample("ring", n, 3, 1.0, np.random.default_rng(2))
    sim = Simulator(mla_moe.program_grad_fn(cfg, stream),
                    params_from_graph(build_graph("ring", n)), gamma,
                    device=CPU)
    x0 = mla_moe.init_params(cfg, 5, CPU)
    state = sim.init(copy.deepcopy(x0), n, torch.Generator())
    state, tr = sim.run_schedule(state, Schedule(
        arrays["partners"], arrays["event_times"], arrays["event_mask"],
        arrays["grad_times"]))
    dyn = replay.prop36(*schedule.graph_edges("ring", n), n, True)
    want = replay.replay(x0, arrays, dyn, gamma,
                         lambda p, b: ref.loss(p, cfg, b), stream.batch)
    np.testing.assert_allclose(tr.loss.numpy(), want["loss"], rtol=1e-6)
    x0_leaves = dict(tree.leaves(x0))
    for key, buf in (("change_x", state.x), ("change_xt", state.x_tilde)):
        for path, a in tree.leaves(buf):
            got = np.array([float((a[w] - x0_leaves[path]).double().norm())
                            for w in range(n)])
            np.testing.assert_allclose(got, want[key][path], rtol=1e-3,
                                       atol=1e-7)


def test_flops_count_the_routed_experts_at_their_share():
    cfg = json.loads((HERE / "configs/kanana2_30b_a3b.json").read_text())
    traffic = {"workers": 4, "batch": 1, "seq": 1024}
    dense = mla_moe.matmul_params_per_token(dict(cfg, n_routed_experts=0))
    routed = 4 * 8 * 3 * 2048 * 768 * 6 / 128
    assert mla_moe.matmul_params_per_token(cfg) == pytest.approx(
        dense + routed)
    attn = 3.0 * 5 * 32 * (192 + 128) * 1024 ** 2
    assert mla_moe.flops_per_round(cfg, traffic) == pytest.approx(
        4 * 1024 * (6 * (dense + routed)) + 4 * attn)
    # the whole tree: 425 M parameters a worker
    total = sum(a.numel() for _, a in tree.leaves(
        Model(mla_moe.model_config(cfg)).init(layers.SHAPE_ONLY)))
    assert 424e6 < total < 427e6


def test_reference_loads_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c",
         f"import json, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
         "import perfbench.reference.mla_moe, perfbench.reference.replay\n"
         "print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert not names & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
