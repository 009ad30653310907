"""The tail of a gradient tick in one pass (``FlatGossipEngine.tick``,
``kernels/a2cid2_mixing`` ``tick_tail_stacked``).

On the CPU: the plain path of ``engine.tick`` against the replay's own
ops (``Simulator._grad_tick``: the descent and the metrics row, then
``engine.mix``), bit for bit on x and x~ and an equal row, at f32 and bf16
buffers and a mixed-dtype tree, eta 0 and eta > 0, a gscale-0 row, a padded
D and gradient leaves that are views at other strides; the launch planner
(``kernel.plan_tick``) against a numpy emulation of the kernel's block ->
(leaf element, buffer column) map; the planner's and the wrapper's
refusals.  On the card (``gpu``-marked, skipped here): the kernel against
the plain version on the same CUDA tensors (x and x~ bit for bit, the row
within the rounding of its sums, padding columns zero, the outputs the
input buffers), on ResNet-18's layout with its real gradients and on a
Qwen-width layout; the replay's span tree and ``fused_ticks`` under
``run_coalesced``; three rounds of ``run_coalesced`` with the kernel
against the same rounds with the plain tail patched in.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.analysis import SpanTracer
from repro_torch.core import (FlatGossipEngine, Simulator, make_schedule,
                              params_from_graph, ring_graph)
from repro_torch.core.tree import tree_flatten
from repro_torch.kernels.a2cid2_mixing import kernel as tk
from repro_torch.kernels.a2cid2_mixing import ops as tops
from repro_torch.kernels.build import source

W, GAMMA = 5, 0.03
ACID = params_from_graph(ring_graph(W))
BASELINE = params_from_graph(ring_graph(W), accelerated=False)
# the row at f32 adds in another order than the eager sums: a few units of
# f32 rounding; at bf16 the eager row rounds its sums to bf16, where the
# kernel's may land one bf16 unit (2^-7 of the value at most) away
ROW_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -6}


def _tree(kind: str, gen: torch.Generator, dev, w: int = W) -> dict:
    """A stacked state tree of odd sizes (so that D is padded and leaves
    start off 16-byte boundaries): a convolution weight, a matrix, a
    vector and a scalar per worker; ``kind`` f32, bf16 or mixed (f32, bf16
    and f16 leaves in one f32 buffer)."""
    dt = {"f32": (torch.float32,) * 4, "bf16": (torch.bfloat16,) * 4,
          "mixed": (torch.float32, torch.bfloat16, torch.float16,
                    torch.float32)}[kind]
    shapes = ((3, 3, 5, 7), (13, 11), (17,), ())
    return {f"l{i}": (torch.randn((w,) + s, generator=gen) * 0.5).to(
        dtype=d, device=dev) for i, (s, d) in enumerate(zip(shapes, dt))}


def _grads(tree: dict, gen: torch.Generator) -> dict:
    """Gradients of the tree's leaves as a gradient function leaves them:
    the convolution weight an HWIO view of an OIHW tensor, the matrix a
    transposed view, the rest contiguous."""
    out = {}
    for k, a in tree.items():
        g = torch.randn(a.shape, generator=gen).to(a.dtype)
        if a.dim() == 5:        # (W, kh, kw, I, O) from (W, O, I, kh, kw)
            g = g.permute(0, 4, 3, 1, 2).contiguous().permute(0, 3, 4, 2, 1)
        elif a.dim() == 3:      # (W, r, c) from (W, c, r)
            g = g.transpose(1, 2).contiguous().transpose(1, 2)
        out[k] = g.to(a.device)
    return out


def _case(kind: str, eta: bool, dev, seed: int = 0):
    """(engine, bx, bxt, grads, gscale, dt_next) of one tick."""
    gen = torch.Generator().manual_seed(seed)
    x = _tree(kind, gen, dev)
    xt = {k: (a.float() + 0.1 * torch.randn(a.shape, generator=gen).to(
        a.device)).to(a.dtype) for k, a in x.items()}
    engine = FlatGossipEngine.for_pytree(x, ACID if eta else BASELINE)
    assert engine.layout.d_real % 128     # padded
    gscale = torch.ones(W, dtype=torch.float32)
    gscale[2] = 0.0                       # a masked tick
    dt_next = torch.rand(W, generator=gen, dtype=torch.float32) * 0.7
    return (engine, engine.pack(x), engine.pack(xt), _grads(x, gen),
            gscale.to(dev), dt_next.to(dev))


CASES = [(kind, eta) for kind in ("f32", "bf16", "mixed")
         for eta in (False, True)]


@pytest.mark.parametrize("kind,eta", CASES)
def test_plain_tick_is_the_replay_ops(kind, eta):
    engine, bx, bxt, grads, gscale, dt = _case(kind, eta, "cpu")
    losses = torch.arange(W, dtype=torch.float32)
    sim = Simulator(lambda x, g, ids: (losses, grads), engine.params, GAMMA,
                    device="cpu")
    ids = torch.arange(W)
    ex, ext, erow = sim._grad_tick(engine, bx.clone(), bxt.clone(), None,
                                   gscale, ids)
    ex, ext = engine.mix(ex, ext, dt)
    gx, gxt, cons, msq = engine.tick(bx.clone(), bxt.clone(), grads,
                                     gscale, GAMMA, dt)
    assert torch.equal(gx, ex) and torch.equal(gxt, ext)
    assert torch.equal(cons, erow[1]) and torch.equal(msq, erow[2])
    assert cons.dtype == msq.dtype == torch.float32 and cons.dim() == 0
    assert not gx[:, engine.layout.d_real:].any()
    assert not gxt[:, engine.layout.d_real:].any()
    # the masked row took no step; eta == 0 leaves the descent as it is
    if not eta:
        assert torch.equal(gx[2], bx[2]) and torch.equal(gxt[2], bxt[2])


# ------------------------------------------------ the planner, emulated

def _segment(first_blocks: np.ndarray, b: int) -> int:
    """The kernel's binary search: the last segment whose first block is
    at or before block ``b``."""
    lo, hi = 0, len(first_blocks) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first_blocks[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _emulate(table: np.ndarray, launches, itemsize: int, w: int) -> dict:
    """Walk every block of every launch as tick_tail_stacked.cu does.
    Returns {buffer column: [(leaf address, element offset of row 0,
    row stride)]}, and asserts that each 16-byte vector access of the
    body lies on a 16-byte boundary of the leaf and of the column."""
    lanes = 16 // itemsize
    chunk, chunk_vecs = tk.TICK_CHUNK, tk.TICK_CHUNK // lanes
    seen: dict = {}

    def touch(s, gi, col):
        seen.setdefault(int(col), []).append((int(s["g"]), int(gi),
                                              int(s["rs"])))

    first = 0
    for count, kind, nblocks in zip(*launches):
        part = table[first:first + count]
        first += count
        assert 1 <= count <= tk.TICK_MAX_SEGMENTS
        assert (part["kind"] == kind).all() and part["first_block"][0] == 0
        for b in range(int(nblocks)):
            s = part[_segment(part["first_block"], b)]
            j = b - int(s["first_block"])
            off, head, body = int(s["off"]), int(s["head"]), int(s["body"])
            if s["kind"] == tk.KIND_VEC:
                n = int(s["n"][2])
                for v in range(j * chunk_vecs,
                               min(j * chunk_vecs + chunk_vecs, body)):
                    e = head + v * lanes
                    assert (int(s["g"]) + e * itemsize) % 16 == 0
                    assert (off + e) % lanes == 0
                    assert w == 1 or int(s["rs"]) % lanes == 0
                    for lane in range(lanes):
                        touch(s, e + lane, off + e + lane)
                scalars = n - body * lanes
                for i in range(j * chunk, min(j * chunk + chunk, scalars)):
                    e = i if i < head else head + body * lanes + (i - head)
                    touch(s, e, off + e)
                continue
            assert s["kind"] == tk.KIND_RUNS
            (a_n, b_n, c_n), (ta, tb, tc) = s["n"], s["t"]
            nta, ntb = -(-a_n // ta), -(-b_n // tb)
            a0, b0 = j % nta * ta, j // nta % ntb * tb
            c0 = j // (nta * ntb) * tc
            # the tile's runs: element r of column c at base + c sc + r
            run = ta * tb
            assert run <= tk.RUN_MAX and tc % 32 == 0 and run * tc <= 1024
            assert run * (tc // 32) <= tk.RUN_MAX
            rv = min(a_n - a0, ta) if tb == 1 else min(b_n - b0, tb) * ta
            cv = min(c_n - c0, tc)
            base = a0 * s["s"][0] + b0 * s["s"][1]
            for cl in range(cv):
                for r in range(rv):
                    a, bb, c = a0 + r % ta, b0 + r // ta, c0 + cl
                    gi = a * s["s"][0] + bb * s["s"][1] + c * s["s"][2]
                    assert gi == base + c * s["s"][2] + r
                    touch(s, gi, off + (a * b_n + bb) * c_n + c)
    return seen


def _fake(shape, strides, dtype):
    """A leaf of the given geometry: a view of a big-enough buffer."""
    size = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return torch.empty(size, dtype=dtype).as_strided(shape, strides)


GEOMETRIES = {
    # (buffer dtype, workers, leaves as (shape, strides, dtype, address mod
    # 16)); offsets follow the leaves
    "aligned": (torch.float32, 4, [((4, 4096), (4096, 1), "f32", 0),
                                   ((4, 10000), (10000, 1), "f32", 0)]),
    "odd offsets": (torch.float32, 3, [((3, 5), (5, 1), "f32", 0),
                                       ((3, 9001), (9001, 1), "f32", 4),
                                       ((3, 8191), (8192, 1), "f32", 12)]),
    "hwio and transposes": (torch.float32, 16, [
        ((16, 3, 3, 64, 128), (73728, 3, 1, 9, 576), "f32", 0),
        ((16, 1, 1, 64, 128), (8192, 1, 1, 1, 64), "f32", 0),
        ((16, 300, 70), (21000, 1, 300), "f32", 0),
        ((16, 2, 33, 40), (2640, 1320, 1, 33), "f32", 0)]),
    "bf16": (torch.bfloat16, 4, [((4, 77), (77, 1), "bf16", 0),
                                 ((4, 5000), (5000, 1), "bf16", 2),
                                 ((4, 40, 96), (3840, 1, 40), "bf16", 0)]),
    "mixed": (torch.float32, 2, [((2, 130), (130, 1), "bf16", 0),
                                 ((2, 64, 8), (512, 8, 1), "f16", 0),
                                 ((2, 4100), (4100, 1), "f32", 0),
                                 ((2,), (1,), "f32", 0)]),
    "one worker": (torch.float32, 1, [((1, 4099), (4099, 1), "f32", 8)]),
    "broadcast": (torch.float32, 3, [((3, 50, 20), (0, 20, 1), "f32", 0),
                                     ((3, 600), (1, 3), "f32", 0)]),
    "long runs": (torch.float32, 2, [((2, 70, 3, 5), (1050, 1, 350, 70),
                                      "f32", 0),
                                     ((2, 7, 40, 9), (2520, 1, 63, 7),
                                      "f32", 0),
                                     ((2, 4, 5, 6), (120, 1, 24, 4), "f32",
                                      0),
                                     ((2, 70, 3, 5), (1050, 1, 70, 210),
                                      "bf16", 0)]),
    # rows contiguous at the buffer dtype in their last dim only: a narrow
    # view of a fused projection's gradient, a broadcast dim
    "narrow rows": (torch.float32, 2, [((2, 3, 40), (192, 64, 1), "f32", 0),
                                       ((2, 5, 8), (64, 8, 1), "f32", 0)]),
    "narrow bf16 rows": (torch.bfloat16, 2, [((2, 3, 40), (192, 64, 1),
                                              "bf16", 0)]),
    "broadcast rows": (torch.float32, 3, [((3, 50, 20), (1000, 0, 1), "f32",
                                           0)]),
    "many leaves": (torch.float32, 2, [((2, 1 + i % 7), (1 + i % 7, 1),
                                        "f32", 0) for i in range(333)]),
}
_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plan_covers_every_column_once(name):
    buf_dtype, w, spec = GEOMETRIES[name]
    leaves, geometry, off = [], [], 0
    for k, (shape, strides, dt, mod) in enumerate(spec):
        leaf = _fake(shape, strides, _DT[dt])
        n = leaf.numel() // w
        addr = (k + 1) * 2 ** 20 + mod
        geometry.append((mod, leaf.stride(0), off, n, tuple(leaf.shape[1:]),
                         leaf.stride()[1:], leaf.dtype))
        leaves.append((leaf, addr, off, n))
        off += n
    d = -(-off // 128) * 128
    table, leaf, launches = tk.plan_tick(tuple(geometry), buf_dtype, w, d)
    counts, kinds, _ = launches
    assert counts.sum() == len(table) == len(leaves)
    assert sorted(leaf.tolist()) == list(range(len(leaves)))
    for kind in (tk.KIND_VEC, tk.KIND_RUNS):
        rows = int((table["kind"] == kind).sum())
        assert (kinds == kind).sum() == -(-rows // tk.TICK_MAX_SEGMENTS)
    table = table.copy()
    table["g"] = [leaves[i][1] for i in leaf]
    seen = _emulate(table, launches, buf_dtype.itemsize, w)
    assert sorted(seen) == list(range(off))
    for leaf, addr, o, n in leaves:
        # column o + k holds the leaf's row-major element k of each row
        idx = np.zeros(n, np.int64)
        if leaf.dim() > 1:
            rm = np.unravel_index(np.arange(n), leaf.shape[1:])
            for dim, stride in enumerate(leaf.stride()[1:]):
                idx += rm[dim] * stride
        for k in range(n):
            (hit,) = seen[o + k]
            assert hit == (addr, idx[k], leaf.stride(0))


def test_plan_refuses_what_the_kernel_cannot_take():
    f32 = torch.float32
    five = torch.empty(2, 3, 4, 5, 6).permute(0, 4, 2, 1, 3)
    with pytest.raises(ValueError, match="merge to 4 > 3"):
        tk.plan_tick(((0, five.stride(0), 0, 360, tuple(five.shape[1:]),
                       five.stride()[1:], f32),), f32, 2, 384)
    with pytest.raises(ValueError, match="overlap"):
        tk.plan_tick(((0, 10, 0, 10, (10,), (1,), f32),
                      (0, 10, 5, 10, (10,), (1,), f32)), f32, 2, 128)
    with pytest.raises(ValueError, match="outside"):
        tk.plan_tick(((0, 200, 0, 200, (200,), (1,), f32),), f32, 2, 128)


def test_wrapper_refuses_cpu_buffers_and_launches_nothing():
    engine, bx, bxt, grads, gscale, dt = _case("f32", True, "cpu")
    before = tk.tick_tail_stacked.launches
    leaves = engine.layout.treedef.flatten_up_to(grads)
    offsets = [s.offset for s in engine.layout.specs]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.tick_tail_stacked(bx, bxt, leaves, offsets, gscale, None,
                             gamma=GAMMA)
    with pytest.raises(ValueError, match="one offset a leaf"):
        tk._tick_geometry(bx, leaves, offsets[:-1])
    with pytest.raises(TypeError, match="does not embed"):
        tk._tick_geometry(bx.to(torch.bfloat16),
                          [g.float() for g in leaves], offsets)
    assert tk.tick_tail_stacked.launches == before


def test_constants_match_the_kernel_source():
    text = source("tick_tail_stacked").read_text()
    assert f"kMaxSegments = {tk.TICK_MAX_SEGMENTS};" in text
    assert f"kChunk = {tk.TICK_CHUNK};" in text
    assert f"sizeof(Segment) == {tk.TICK_SEGMENT.itemsize}" in text
    assert f"kKindVec = {tk.KIND_VEC};" in text
    assert f"kKindRuns = {tk.KIND_RUNS};" in text
    assert f"kRunMax = {tk.RUN_MAX};" in text
    assert f"kLeafBF16 = {tk.LEAF_CODE[torch.bfloat16]};" in text


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _hold(engine, bx, bxt, grads, gscale, dt, rtol):
    """The kernel against the plain version on the same CUDA tensors."""
    leaves = engine.layout.treedef.flatten_up_to(grads)
    offsets = [s.offset for s in engine.layout.specs]
    eta = engine.params.eta
    coeff = None if eta == 0.0 else 0.5 * (1.0 - torch.exp(-2.0 * eta * dt))
    want = tops.tick_tail(bx, bxt, leaves, offsets, gscale, coeff,
                          gamma=GAMMA, backend="ref")
    px, pxt = bx.data_ptr(), bxt.data_ptr()
    before = tk.tick_tail_stacked.launches
    got = tops.tick_tail(bx, bxt, leaves, offsets, gscale, coeff,
                         gamma=GAMMA)
    torch.cuda.synchronize()
    assert tk.tick_tail_stacked.launches == before + 1
    assert got[0].data_ptr() == px and got[1].data_ptr() == pxt
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    d_real = engine.layout.d_real
    assert not got[0][:, d_real:].any() and not got[1][:, d_real:].any()
    for g, e in zip(got[2:], want[2:]):
        assert g.dtype == torch.float32 and g.dim() == 0
        torch.testing.assert_close(g, e, rtol=rtol, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,eta", CASES)
def test_cuda_tick_matches_plain(kind, eta):
    dev = _cuda()
    engine, bx, bxt, grads, gscale, dt = _case(kind, eta, dev)
    _hold(engine, bx, bxt, grads, gscale, dt, ROW_RTOL[bx.dtype])


@pytest.mark.gpu
def test_cuda_tick_on_resnet18_gradients():
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.models.resnet import (init_resnet, resnet18_cifar,
                                           resnet_grad_fn)
    dev = _cuda()
    cfg = resnet18_cifar()
    params = init_resnet(torch.Generator(device=dev).manual_seed(3), cfg)
    sim = Simulator(resnet_grad_fn(cfg, SyntheticCIFAR(batch_size=2)),
                    ACID, GAMMA)
    state = sim.init(params, 4, torch.Generator(device=dev).manual_seed(4))
    engine = FlatGossipEngine.for_pytree(state.x, ACID)
    bx = engine.pack(state.x)
    _, grads = sim.grad_fn(engine.unpack(bx), state.generator,
                           torch.arange(4, device=dev))
    leaves = tree_flatten(grads)[0]
    # the convolutions' gradients are strided views: the runs path
    assert any(not g.is_contiguous() for g in leaves)
    bxt = bx + 1e-3 * torch.randn(bx.shape, device=dev)
    bxt[:, engine.layout.d_real:] = 0
    gscale = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    dt = torch.tensor([0.1, 0.5, 0.0, 1.3], device=dev)
    _hold(engine, bx, bxt, grads, gscale, dt, ROW_RTOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tick_on_a_qwen_width_layout(dtype):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    w, layers, dm, ff = 4, 2, 1024, 3072
    shapes = {"embed": (4096, dm), "norm": (dm,),
              "wq": (layers, dm, 16 * 128), "wk": (layers, dm, 8 * 128),
              "q_norm": (layers, 128), "w_up": (layers, dm, ff),
              "w_down": (layers, ff, dm)}
    x = {k: torch.randn((w,) + s, generator=gen, device=dev).to(dtype)
         for k, s in shapes.items()}
    grads = {k: torch.randn(a.shape, generator=gen, device=dev).to(dtype)
             for k, a in x.items()}
    # a gradient left transposed, as a matmul's may be; a narrow view of a
    # fused projection's gradient; a broadcast over the layers
    grads["w_up"] = torch.randn((w, layers, ff, dm), generator=gen,
                                device=dev).to(dtype).transpose(-1, -2)
    grads["wk"] = torch.randn((w, layers, dm, 24 * 128), generator=gen,
                              device=dev).to(dtype)[..., 16 * 128:]
    grads["q_norm"] = torch.randn((w, 1, 128), generator=gen,
                                  device=dev).to(dtype).expand(w, layers, 128)
    engine = FlatGossipEngine.for_pytree(x, ACID)
    bx = engine.pack(x)
    bxt = (bx.float() + 0.01 * torch.randn(bx.shape, generator=gen,
                                           device=dev)).to(dtype)
    bxt[:, engine.layout.d_real:] = 0
    gscale = torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)
    dt = torch.tensor([0.2, 0.0, 0.9, 0.4], device=dev)
    _hold(engine, bx, bxt, grads, gscale, dt, ROW_RTOL[dtype])


def _quadratic_sim(dev):
    """16 workers pulling toward their own optimum on a ring, d = 1000."""
    target = torch.randn(16, 1000, generator=torch.Generator().manual_seed(
        6)).to(dev)

    def grad_fn(x, generator, ids):
        g = {"a": x["a"] - target[ids, :600].reshape(-1, 20, 30),
             "b": (x["b"] - target[ids, 600:]).t().contiguous().t()}
        return 0.5 * (g["a"] ** 2).sum((1, 2)), g

    g = ring_graph(16)
    x0 = {"a": torch.zeros(20, 30, device=dev),
          "b": torch.zeros(400, device=dev)}
    return Simulator(grad_fn, params_from_graph(g), GAMMA), g, x0


@pytest.mark.gpu
def test_cuda_replay_spans_and_fused_ticks():
    dev = _cuda()
    sim, g, x0 = _quadratic_sim(dev)
    sched = make_schedule(g, 6, comms_per_grad=1.5, seed=2)
    state = sim.init(x0, 16, torch.Generator(device=dev).manual_seed(1))
    tracer = SpanTracer("test", device=dev)
    with tracer.activate():
        sim.run_schedule(state, sched)
    tracer.resolve()
    spans = [e for e in tracer.events if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in spans}
    ticks = [e for e in spans if e["name"] == "replay.tick"]
    assert len(ticks) == 6
    for tick in ticks:
        assert [c["name"] for c in spans
                if c["args"]["parent"] == tick["args"]["id"]
                and c["name"] != "python.gc"] == \
            ["replay.grad", "replay.tail"]
    (call,) = [e for e in spans if e["name"] == "replay.call"]
    mixes = [e for e in spans if e["name"] == "replay.mix"]
    assert len(mixes) == 1 and by_id[mixes[0]["args"]["parent"]] is call
    (sample,) = [e for e in tracer.events
                 if e["ph"] == "C" and e["name"] == "replay"]
    assert sample["args"]["fused_ticks"] == sample["args"]["ticks"] == 6
    assert call["args"]["fused_ticks"] == 6


@pytest.mark.gpu
def test_cuda_replay_equals_the_plain_tail(monkeypatch):
    from repro_torch.core import engine as engine_mod
    dev = _cuda()
    sim, g, x0 = _quadratic_sim(dev)
    sched = make_schedule(g, 3, comms_per_grad=1.0, seed=8)
    runs = {}
    for arm in ("kernel", "plain"):
        if arm == "plain":
            monkeypatch.setattr(
                engine_mod, "tick_tail",
                lambda *a, **kw: tops.tick_tail(*a, backend="ref", **kw))
        before = tk.tick_tail_stacked.launches
        state = sim.init(x0, 16, torch.Generator(device=dev).manual_seed(7))
        runs[arm] = sim.run_schedule(state, sched)
        torch.cuda.synchronize()
        assert tk.tick_tail_stacked.launches - before == \
            (3 if arm == "kernel" else 0)
    (fk, tk_), (fp, tp) = runs["kernel"], runs["plain"]
    for a, b in zip(tree_flatten((fk.x, fk.x_tilde))[0],
                    tree_flatten((fp.x, fp.x_tilde))[0]):
        assert torch.equal(a, b)
    assert torch.equal(tk_.loss, tp.loss)
    torch.testing.assert_close(tk_.consensus, tp.consensus,
                               rtol=ROW_RTOL[torch.float32], atol=0.0)
    torch.testing.assert_close(tk_.mean_param_norm, tp.mean_param_norm,
                               rtol=ROW_RTOL[torch.float32], atol=0.0)


def test_plain_tick_reads_strided_leaves_as_packed():
    """Gradient leaves at other strides (an HWIO view, a transposed
    matrix) give what their contiguous copies give."""
    engine, bx, bxt, grads, gscale, dt = _case("f32", True, "cpu", seed=3)
    assert any(not g.is_contiguous() for g in grads.values())
    packed = {k: v.contiguous() for k, v in grads.items()}
    a = engine.tick(bx.clone(), bxt.clone(), grads, gscale, GAMMA, dt)
    b = engine.tick(bx.clone(), bxt.clone(), packed, gscale, GAMMA, dt)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
