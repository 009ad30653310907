"""The op-level cost counter (``repro_torch.analysis.op_cost``).

The JAX package's ``test_hlo_cost.py`` holds its HLO parser to five
structures (a loop's trip count, unrolled equal to looped, nested loops
multiplying, write bytes scaling with trips, einsum FLOPs); the same five
hold here on eager loops, where every iteration dispatches its ops.  Then
``record`` (the hand kernels' report), views, peaks and collectives, and
the counted FLOPs of reduced nano-lm's prefill and train steps against
JAX's ``cost_from_hlo`` of the compiled steps on the CPU: the prefill
and the train step exactly (within rel 1e-3; the train step was 4.8e-4
over while autograd differentiated RMSNorm's sum-of-squares dot with two
products, and is exact since the port takes the JAX package's custom
VJP, one product).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_cost import cost_from_hlo
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.models.transformer import Model as JModel
from repro_torch.analysis.op_cost import OpCounter, count, record
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models.transformer import Model

N = 128
FLOPS = 2 * N ** 3


def _x(device="cpu"):
    return torch.ones((N, N), device=device)


def _loop(x, trips):
    c = x
    for _ in range(trips):
        c = c @ x
    return c


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_trip_count_counted(device):
    assert count(_loop, _x(device), 8)[1].flops == 8 * FLOPS


def test_unrolled_matches_loop():
    def unrolled(x):
        x = x @ x
        x = x @ x
        x = x @ x
        x = x @ x
        x = x @ x
        return x @ x

    def looped(x):
        for _ in range(6):
            x = x @ x
        return x

    a = count(looped, _x())[1]
    b = count(unrolled, _x())[1]
    assert a.flops == b.flops == 6 * FLOPS
    assert a.write_bytes == b.write_bytes


def test_nested_loops_multiply():
    def nested(x):
        c = x
        for _ in range(3):
            for _ in range(4):
                c = c @ x
        return c

    assert count(nested, _x("meta"))[1].flops == 12 * FLOPS


def test_write_bytes_scale_with_trips():
    def f(x, trips):
        c = x
        for _ in range(trips):
            c = torch.tanh(c @ x)
        return c

    a = count(f, _x(), 10)[1].write_bytes
    b = count(f, _x(), 5)[1].write_bytes
    assert a > 1.5 * b
    assert a == 10 * 2 * N * N * 4      # the product and the tanh, f32


def test_einsum_flops():
    a, b = torch.ones(64, 256), torch.ones(256, 32)
    cost = count(torch.einsum, "ij,jk->ik", a, b)[1]
    assert cost.flops == 2 * 64 * 256 * 32


def test_record_adds_work_to_every_active_counter():
    record("outside", 1.0, 1.0)      # no counter: a no-op
    with OpCounter() as outer:
        with OpCounter() as inner:
            record("kernel", 10.0, 20.0)
            y = _x() @ _x()
        record("kernel", 5.0, 6.0)
    assert inner.cost().flops == 10.0 + FLOPS
    assert inner.cost().recorded == {"kernel": {"calls": 1, "flops": 10.0,
                                                "bytes": 20.0}}
    assert outer.cost().flops == 15.0 + FLOPS
    assert outer.cost().recorded["kernel"] == {"calls": 2, "flops": 15.0,
                                               "bytes": 26.0}
    # the two ones and their product
    assert outer.cost().write_bytes == 26.0 + 3 * N * N * 4


def test_views_write_nothing_and_in_place_ops_count_their_output():
    x = _x()

    def views(x):
        return (x.view(-1), x.t(), x.reshape(64, 256), x[3:], x.expand(2, N, N),
                x.unsqueeze(0), x.detach(), torch.empty_like(x))

    cost = count(views, x)[1]
    assert cost.write_bytes == 0 and cost.flops == 0
    assert count(lambda t: t.add_(1.0), x.clone())[1].write_bytes == N * N * 4
    # a reshape that must copy writes the copy once
    assert count(lambda t: t.t().reshape(-1), x)[1].write_bytes == N * N * 4


def test_peak_live_bytes_follows_storage_lifetimes():
    def chain(x):
        a = x + 1        # 1 live
        b = a * 2        # 2 live
        del a            # 1 live
        c = b - 1        # 2 live
        d = c.view(-1)   # a view: no new storage
        return d

    cost = count(chain, _x("meta"))[1]
    assert cost.peak_live_bytes == 2 * N * N * 4
    with OpCounter() as c:
        y = None
        for _ in range(5):
            y = _x() @ _x()     # the last product lives while the next is made
    assert c.cost().peak_live_bytes == 4 * N * N * 4
    del y


def test_functional_collectives_counted(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        ops, group = torch.ops._c10d_functional, dist.group.WORLD.group_name
        x = torch.ones(1000)
        with OpCounter() as c:
            ops.wait_tensor(ops.all_reduce(x, "sum", group))
            ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", 1, group))
    finally:
        dist.destroy_process_group()
    cost = c.cost()
    assert cost.collective_detail == {"all-reduce": 4000.0,
                                      "reduce-scatter": 4000.0}
    assert cost.collective_bytes == 8000.0
    assert count(_loop, _x("meta"), 2)[1].collective_bytes == 0.0


# ------------------------------------------- against JAX's HLO cost model

B, S, M = 4, 64, 2


@pytest.fixture(scope="module")
def nano():
    return get_config("nano-lm", reduced=True), jax_config("nano-lm",
                                                           reduced=True)


def _meta_tokens(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def test_prefill_flops_equal_jax_cost_from_hlo(nano):
    cfg, jcfg = nano
    jm = JModel(jcfg)
    jp = jsteps.abstract_params(jm)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    hlo = jax.jit(jsteps.make_prefill_step(jm)).lower(
        jp, {"inputs": tok}).compile().as_text()
    want = cost_from_hlo(hlo).flops
    m = Model(cfg)
    _, cost = count(steps.make_prefill_step(m), steps.abstract_params(m),
                    {"inputs": _meta_tokens((B, S))})
    assert cost.flops == pytest.approx(want, rel=1e-3)


def test_train_flops_within_two_percent_of_jax(nano):
    cfg, jcfg = nano
    jm = JModel(jcfg)
    jstep, jopt = jsteps.make_train_step(jm, num_microbatches=M)
    mb = jax.ShapeDtypeStruct((M, B // M, S), jnp.int32)
    hlo = jax.jit(jstep).lower(jsteps.abstract_train_state(jm, jopt),
                               {"inputs": mb, "labels": mb}
                               ).compile().as_text()
    want = cost_from_hlo(hlo).flops
    m = Model(cfg)
    step, opt = steps.make_train_step(m, num_microbatches=M)
    batch = {k: _meta_tokens((M, B // M, S)) for k in ("inputs", "labels")}
    _, cost = count(step, steps.abstract_train_state(m, opt), batch)
    assert cost.flops == pytest.approx(want, rel=1e-3)
    # remat recounts the forward: more FLOPs than without it
    plain, _ = steps.make_train_step(m, num_microbatches=M, remat=False)
    _, no_remat = count(plain, steps.abstract_train_state(m, opt), batch)
    assert no_remat.flops < cost.flops
