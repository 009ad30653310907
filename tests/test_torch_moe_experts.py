"""The dropless expert op (``kernels/moe_experts``): the plain routing
tables against their definition, the autograd op (its ``vmap`` rules, the
plain version on the CPU) against the dense oracle's autograd, worker by
worker under ``torch.func.vmap``; on the card (``gpu``-marked, skipped
here) the kernels against the plain version on ragged groups (empty
groups, one group holding every row, every pick held), one launch a
product, and the tables bit for bit."""
import pytest
import torch
from torch.func import grad, vmap

from repro_torch.kernels.moe_experts import kernel as mk
from repro_torch.kernels.moe_experts import ops
from repro_torch.kernels.moe_experts.ref import moe_experts_ref, route_ref


def _ids(w, t, k, e, seed, kind="random"):
    """(W, T, K) distinct expert ids a token: random, every token's picks
    on experts 0 .. K - 1 ("crowd": a group holds every token), or none on
    experts 0 and 1 ("empty": their groups hold no row)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "crowd":
        return torch.arange(k).expand(w, t, k).clone()
    low = 2 if kind == "empty" else 0
    return torch.stack([torch.stack([
        torch.randperm(e - low, generator=g)[:k] + low for _ in range(t)])
        for _ in range(w)])


def _case(w=2, t=12, k=3, e=10, n=4, d=24, f=20, seed=0, kind="random",
          device="cpu"):
    g = torch.Generator().manual_seed(seed + 100)
    ids = _ids(w, t, k, e, seed, kind)
    x = torch.randn(w, t, d, generator=g)
    gates = torch.rand(w, t, k, generator=g)
    wg = torch.randn(w, n, d, f, generator=g) / d ** 0.5
    wu = torch.randn(w, n, d, f, generator=g) / d ** 0.5
    wd = torch.randn(w, n, f, d, generator=g) / f ** 0.5
    return [a.to(device) for a in (x, gates, ids, wg, wu, wd)]


@pytest.mark.parametrize("kind", ["random", "crowd", "empty"])
def test_route_tables(kind):
    x, gates, ids, *_ = _case(kind=kind)
    e0, n = 1, 4
    meta, row, pick = route_ref(ids, e0, n)
    w, t, k = ids.shape
    held = (ids >= e0) & (ids < e0 + n)
    assert torch.equal(row >= 0, held)
    counts = meta[:, n:]
    assert int(counts.sum()) == int(held.sum())
    first = meta[:, :n].reshape(-1)
    assert torch.equal(first, torch.cumsum(counts.reshape(-1), 0)
                       - counts.reshape(-1))
    total = int(counts.sum())
    flat = row.reshape(-1)
    # every held pick has its own row; the row's pick points back to it
    assert sorted(flat[flat >= 0].tolist()) == list(range(total))
    p = torch.nonzero(flat >= 0)[:, 0]
    assert torch.equal(pick.reshape(-1)[flat[p].long()].long(), p)
    # a group's rows are its picks in (t, k) order
    group = (ids - e0 + n * torch.arange(w)[:, None, None]).reshape(-1)
    for gi in range(w * n):
        mine = p[group[p] == gi]
        assert flat[mine].tolist() == list(range(
            int(first[gi]), int(first[gi]) + len(mine)))
    assert pick.shape == (w, t * min(k, n))


def _dense_grads(x, gates, ids, wg, wu, wd, e0, dout):
    ins = [a.clone().requires_grad_() for a in (x, gates, wg, wu, wd)]
    out = moe_experts_ref(ins[0], ids, ins[1], *ins[2:], e0)
    return out.detach(), torch.autograd.grad(out, ins, dout)


@pytest.mark.parametrize("kind", ["random", "crowd", "empty"])
def test_op_under_vmap_matches_the_dense_oracle(kind):
    """The model's call: W = 1 inside a vmap over the workers; the loss a
    weighted sum, so dout is the weights."""
    x, gates, ids, wg, wu, wd = _case(kind=kind)
    e0, n = 0, wg.shape[1]
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))

    def one(x, gates, ids, wg, wu, wd, dout):
        routing = ops.moe_route(ids[None], e0, n)
        out = ops.moe_experts(x[None], gates[None], ids[None], routing,
                              wg[None], wu[None], wd[None], e0)[0]
        return (out * dout).sum(), out

    out = vmap(lambda *a: one(*a)[1])(x, gates, ids, wg, wu, wd, dout)
    grads = vmap(grad(lambda *a: one(*a)[0], argnums=(0, 1, 3, 4, 5)))(
        x, gates, ids, wg, wu, wd, dout)
    want, want_g = _dense_grads(x, gates, ids, wg, wu, wd, e0, dout)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    for got, exp in zip(grads, want_g):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_unheld_picks_add_nothing():
    x, gates, ids, wg, wu, wd = _case()
    e0 = int(ids.max()) + 1         # a share past every pick
    routing = ops.moe_route(ids, e0, wg.shape[1])
    out = ops.moe_experts(x, gates, ids, routing, wg, wu, wd, e0)
    assert not out.any() and not routing[0][:, wg.shape[1]:].any()
    assert (routing[1] == -1).all()


def test_keep_picks_keeps_every_route_in_order():
    """Each route op inside ``keep_picks`` adds a copy of its ids, a vmap's
    folded to (W, T, K); none is kept outside."""
    x, gates, ids, wg, wu, wd = _case()
    n = wg.shape[1]
    with ops.keep_picks() as kept:
        ops.moe_route(ids, 0, n)
        vmap(lambda i: ops.moe_route(i[None], 1, n)[0])(ids.flip(0))
    assert len(kept) == 2
    assert torch.equal(kept[0], ids) and torch.equal(kept[1], ids.flip(0))
    kept[0].zero_()
    assert ids.any()                 # a copy, not the op's tensor
    ops.moe_route(ids, 0, n)
    assert len(kept) == 2 and ops._kept is None


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (W, T, K, E, n, D, F, kind): a tile edge crossed in every dimension;
# groups left empty; groups of every token; one group holding every row;
# every pick held (n = E: W T K rows); the cell's shape
CARD = [(2, 77, 3, 10, 4, 96, 80, "random"),
        (3, 150, 4, 16, 4, 64, 48, "empty"),
        (2, 130, 4, 8, 8, 72, 40, "crowd"),
        (1, 300, 1, 4, 4, 64, 64, "crowd"),
        (2, 70, 3, 6, 6, 64, 64, "random"),
        (4, 1024, 6, 128, 8, 2048, 768, "random")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD, ids=lambda c: f"{c[-1]}-{c[0]}x{c[1]}"
                         f"x{c[2]}-E{c[3]}n{c[4]}-{c[5]}x{c[6]}")
def test_cuda_kernels_match_the_plain_version(case):
    dev = _cuda()
    w, t, k, e, n, d, f, kind = case
    x, gates, ids, wg, wu, wd = _case(w, t, k, e, n, d, f, seed=w * t,
                                      kind=kind, device=dev)
    e0 = 0
    dout = torch.randn(x.shape, device=dev)
    before = dict(mk.moe_experts.by_op)
    meta, row, pick = mk.route(ids, e0, n, w * t * min(k, n))
    r_meta, r_row, r_pick = route_ref(ids, e0, n)
    torch.cuda.synchronize()
    assert torch.equal(meta, r_meta) and torch.equal(row, r_row)
    total = int(meta[:, n:].sum())
    assert torch.equal(pick.reshape(-1)[:total], r_pick.reshape(-1)[:total])
    hg, hu, y = mk.products(x, gates, meta, row, pick, wg, wu, wd, e0)
    out = mk.combine(y, gates, row, t)
    grads = mk.backward(dout, x, gates, meta, row, pick, wg, wu, wd, hg, hu,
                        y, e0)
    after = mk.moe_experts.by_op
    assert {op: after.get(op, 0) - before.get(op, 0) for op in after} == {
        op: 1 for op in mk.OPS}
    want, want_g = _dense_grads(x, gates, ids, wg, wu, wd, e0, dout)
    scale = want.abs().max().clamp_min(1e-30)
    assert float((out - want).abs().max() / scale) < 1e-5
    for got, exp in zip(grads, want_g):
        gs = exp.abs().max().clamp_min(1e-30)
        assert float((got - exp).abs().max() / gs) < 1e-5


@pytest.mark.gpu
def test_cuda_op_under_vmap_matches_the_plain_version():
    dev = _cuda()
    x, gates, ids, wg, wu, wd = _case(3, 40, 4, 12, 5, 64, 32, device=dev)
    e0, n = 2, wg.shape[1]

    def loss(backend):
        def one(x, gates, ids, wg, wu, wd):
            routing = ops.moe_route(ids[None], e0, n, backend=backend)
            out = ops.moe_experts(x[None], gates[None], ids[None], routing,
                                  wg[None], wu[None], wd[None], e0,
                                  backend=backend)
            return (out * out).sum()
        return vmap(grad(one, argnums=(0, 1, 3, 4, 5)))(x, gates, ids, wg,
                                                         wu, wd)

    launched = mk.moe_experts.launches
    got = loss("auto")
    # one launch of each of the ten ops for all three workers
    assert mk.moe_experts.launches - launched == 10
    for g, e in zip(got, loss("ref")):
        assert float((g - e).abs().max() / e.abs().max()) < 1e-5


def test_op_counter_is_seen_only_while_active():
    """The kernel wrappers read the held rows from the card (a sync) only
    under an op counter: the replay never has one."""
    from repro_torch.analysis import op_cost
    assert not op_cost.counting()
    with op_cost.OpCounter():
        assert op_cost.counting()
    assert not op_cost.counting()
