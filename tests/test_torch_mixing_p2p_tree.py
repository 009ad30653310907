"""``mixing_p2p`` as one launch per parameter tree.

On the CPU: the launch planner (``kernel.plan_launches``, ``out_offsets``)
against a numpy emulation of the kernel's block -> (leaf, element range)
map, the wrapper's refusals, and ``ops.gossip_event_pytree``'s plain path
against the JAX package's on a tree of odd, empty and mixed-dtype leaves.
On the card (``gpu``-marked, skipped here): the tree kernel against the
plain version bit for bit at f32 and bf16, its launch count and a CUDA
graph of it.
"""
from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.a2cid2_mixing import ops as jops
from repro_torch.kernels.a2cid2_mixing import kernel as tk
from repro_torch.kernels.a2cid2_mixing import ops as tops
from repro_torch.kernels.a2cid2_mixing.ref import mixing_p2p_ref
from repro_torch.kernels.build import source

ACID = dict(eta=0.11, alpha=0.5, alpha_t=1.37)
F32 = dict(rtol=1e-6, atol=1e-6)
ITEMSIZE = {"f32": 4, "bf16": 2}


# ------------------------------------------------ the planner, emulated

def _kernel_segment(first_blocks: np.ndarray, b: int) -> int:
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


def _emulate(table: np.ndarray, blocks: int, itemsize: int, chunk: int,
             counts: dict) -> None:
    """Walk every block of one launch as mixing_p2p.cu does, adding one to
    ``counts[x address]`` at each element it writes, and assert that every
    16-byte vector access of the five arrays is aligned."""
    lanes = 16 // itemsize
    per_block = chunk // lanes
    for b in range(blocks):
        s = table[_kernel_segment(table["first_block"], b)]
        j = b - int(s["first_block"])
        head, body, n = int(s["head"]), int(s["body"]), int(s["n"])
        hits = counts[int(s["x"])]
        v0, v1 = j * per_block, min(j * per_block + per_block, body)
        if v1 > v0:
            for key in ("x", "x_tilde", "xp", "out_x", "out_xt"):
                assert (int(s[key]) + (head + v0 * lanes) * itemsize) % 16 \
                    == 0, f"block {b}: {key} vector misaligned"
            hits[head + v0 * lanes:head + v1 * lanes] += 1
        scalars = n - body * lanes
        e0, e1 = j * chunk, min(j * chunk + chunk, scalars)
        i = np.arange(e0, max(e0, e1))
        np.add.at(hits, np.where(i < head, i, head + body * lanes + i - head),
                  1)


def _fake_tree(seed: int, itemsize: int, leaves: int):
    """(x, x_tilde, xp) addresses and lengths of ``leaves`` leaves: lengths
    0 to 70,000 (some empty, some of one element), each array at an
    element offset 0-3 from a 4096-byte boundary, the three offsets equal
    in most leaves."""
    rng = np.random.default_rng(seed)
    ns = rng.integers(0, 70_001, leaves)
    ns[rng.choice(leaves, 6, replace=False)] = [0, 0, 1, 1, 2, 3]
    ptrs = []
    for k, n in enumerate(ns):
        offs = rng.integers(0, 4, 3)
        if rng.random() < 0.7:
            offs[:] = offs[0]
        ptrs.append(tuple(int((3 * k + a + 1) << 20) + int(o) * itemsize
                          for a, o in enumerate(offs)))
    return ptrs, [int(n) for n in ns]


@pytest.mark.parametrize("chunk", [tk.CHUNK, 2048, 8192])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_covers_every_element_once(seed, dtype, chunk):
    itemsize = ITEMSIZE[dtype]
    ptrs, ns = _fake_tree(seed, itemsize, tk.MAX_SEGMENTS + 5)
    offsets, total = tk.out_offsets([p[0] for p in ptrs], ns, itemsize)
    out_x, out_xt = 1 << 34, 1 << 35      # OUT_ALIGN-aligned buffers
    rows = []
    for (x, xt, xp), n, o in zip(ptrs, ns, offsets):
        assert (out_x + o * itemsize) % 16 == x % 16
        assert (out_x + o * itemsize) % tk.OUT_ALIGN == x % tk.OUT_ALIGN
        if n:
            rows.append((x, xt, xp, out_x + o * itemsize,
                         out_xt + o * itemsize, n))
    # the outputs lie in the buffer, one after another, without overlap
    assert all(o + n <= nxt for o, n, nxt in
               zip(offsets, ns, offsets[1:] + [total]))
    launches = tk.plan_launches(rows, itemsize, chunk=chunk)
    assert len(launches) == math.ceil(len(rows) / tk.MAX_SEGMENTS) == 2
    counts = {r[0]: np.zeros(r[5], np.int64) for r in rows}
    lengths = []
    for table, blocks in launches:
        assert table.dtype == tk.SEGMENT and table.dtype.itemsize == 64
        assert 1 <= len(table) <= tk.MAX_SEGMENTS
        first = table["first_block"]
        assert first[0] == 0 and (np.diff(first) >= 1).all()
        assert blocks > first[-1]
        lengths += list(table["n"])
        _emulate(table, blocks, itemsize, chunk, counts)
    assert lengths == sorted(lengths, reverse=True)   # longest first
    assert all((c == 1).all() for c in counts.values())
    # every leaf whose five addresses line up streams 16-byte vectors
    vec = [int(s["x"]) for t, _ in launches for s in t if s["body"] > 0]
    aligned = [r[0] for r in rows if len({p % 16 for p in r[:5]}) == 1
               and r[5] - (16 - r[0] % 16) % 16 // itemsize >= 16 //
               itemsize]
    assert sorted(vec) == sorted(aligned)


@pytest.mark.parametrize("max_segments", [1, 3, tk.MAX_SEGMENTS])
def test_plan_splits_launches_at_max_segments(max_segments):
    ptrs, ns = _fake_tree(7, 4, 11)
    rows = [(*p, 1 << 34, 1 << 35, n) for p, n in zip(ptrs, ns) if n]
    launches = tk.plan_launches(rows, 4, max_segments=max_segments)
    assert len(launches) == math.ceil(len(rows) / max_segments)
    assert sum(len(t) for t, _ in launches) == len(rows)


def test_constants_match_the_kernel_source():
    text = source("mixing_p2p").read_text()
    assert f"kMaxSegments = {tk.MAX_SEGMENTS};" in text
    assert f"kChunk = {tk.CHUNK};" in text
    assert "sizeof(Segment) == 64" in text
    fields = re.search(r"struct Segment \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == list(tk.SEGMENT.names)


# ------------------------------------------------ the wrapper on the CPU

def test_tree_wrapper_refuses_and_launches_nothing():
    x = [torch.ones(5), torch.ones(2, 3)]
    dt = torch.tensor(0.5)
    before = tk.mixing_p2p.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.mixing_p2p_tree(x, x, x, dt, **ACID)
    with pytest.raises(ValueError, match="share x's shape"):
        tk.mixing_p2p_tree(x, [x[0], torch.ones(6)], x, dt, **ACID)
    with pytest.raises(ValueError, match="as many leaves"):
        tk.mixing_p2p_tree(x, x[:1], x, dt, **ACID)
    with pytest.raises(TypeError, match="not supported"):
        tk.mixing_p2p_tree([torch.ones(3, dtype=torch.float64)] * 1,
                           [torch.ones(3, dtype=torch.float64)],
                           [torch.ones(3, dtype=torch.float64)], dt, **ACID)
    with pytest.raises(TypeError, match="x is torch.float32"):
        tk.mixing_p2p_tree(x, [x[0].bfloat16(), x[1]], x, dt, **ACID)
    with pytest.raises(ValueError, match="contiguous"):
        tk.mixing_p2p_tree(x, [x[0], torch.ones(3, 2).t()], x, dt, **ACID)
    assert tk.mixing_p2p_tree([], [], [], dt, **ACID) == ([], [])
    assert tk.mixing_p2p.launches == before


def _odd_tree(seed: int):
    """Three trees of odd, empty, one-element and 0-dim leaves, f32 and
    bf16 mixed."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (0,), "b": (1,), "c": (), "d": (7, 3), "e": (4099,),
              "f": (2, 0, 3), "g": (33, 17)}
    bf16 = {"b", "e", "g"}
    trees = []
    for _ in range(3):
        trees.append({k: rng.normal(size=s).astype(np.float32)
                      for k, s in shapes.items()})
    return trees, bf16


@pytest.mark.parametrize("dt", [0.0, 0.45])
def test_pytree_plain_path_matches_jax_on_odd_leaves(dt):
    trees, bf16 = _odd_tree(3)
    jtrees = [{k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
               for k, v in t.items()} for t in trees]
    ttrees = [{k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k in bf16 else torch.float32)
        for k, v in t.items()} for t in trees]
    before = tk.mixing_p2p.launches
    got = tops.gossip_event_pytree(*ttrees, dt, **ACID)
    assert tk.mixing_p2p.launches == before   # the CPU takes the plain one
    want = jops.gossip_event_pytree(*jtrees, dt, **ACID)
    for g, w in zip(got, want):
        for k in trees[0]:
            assert tuple(g[k].shape) == tuple(w[k].shape)
            a = g[k].float().numpy()
            b = np.asarray(w[k], np.float32)
            if k in bf16:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, **F32)


# ------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _card_tree(dev, n_leaves: int, seed: int):
    """Three lists of leaves on the card: empty and one-element leaves, odd
    lengths, views 1 and 3 elements past an aligned start, f32 and bf16
    mixed; the bases they view, to check that they stay unchanged."""
    rng = np.random.default_rng(seed)
    xs, xts, xps, bases = [], [], [], []
    for k in range(n_leaves):
        n = [0, 1, 2, 7, 127, 4099, 70_001][k % 7] if k < 14 else \
            int(rng.integers(0, 70_000))
        off = (0, 1, 3)[k % 3]
        dtype = torch.bfloat16 if k % 4 == 1 else torch.float32
        three = []
        for _ in range(3):
            base = torch.from_numpy(rng.normal(size=n + 8).astype(
                np.float32)).to(dev, dtype)
            bases.append((base, base.clone()))
            three.append(base[off:off + n])
        if k % 5 == 2:
            three = [t.reshape(1, n) for t in three]
        for lst, t in zip((xs, xts, xps), three):
            lst.append(t)
    return xs, xts, xps, bases


def _want_launches(xs) -> int:
    per = {}
    for x in xs:
        per[x.dtype] = per.get(x.dtype, 0) + (x.numel() > 0)
    return sum(math.ceil(v / tk.MAX_SEGMENTS) for v in per.values())


@pytest.mark.gpu
@pytest.mark.parametrize("n_leaves", [5, 56, 2 * tk.MAX_SEGMENTS + 3])
def test_cuda_tree_matches_plain_bit_for_bit(n_leaves):
    dev = _cuda()
    xs, xts, xps, bases = _card_tree(dev, n_leaves, seed=n_leaves)
    dt = torch.tensor(0.45, device=dev)
    before = tk.mixing_p2p.launches
    ox, oxt = tk.mixing_p2p_tree(xs, xts, xps, dt, **ACID)
    torch.cuda.synchronize()
    assert tk.mixing_p2p.launches - before == _want_launches(xs)
    for k, (x, xt, xp) in enumerate(zip(xs, xts, xps)):
        rx, rxt = mixing_p2p_ref(x, xt, xp, dt, **ACID)
        assert ox[k].shape == x.shape and ox[k].dtype == x.dtype
        assert torch.equal(ox[k], rx) and torch.equal(oxt[k], rxt), k
        if x.numel():
            assert ox[k].data_ptr() % 16 == x.data_ptr() % 16
    assert all(torch.equal(b, c) for b, c in bases)   # inputs unchanged


@pytest.mark.gpu
def test_cuda_tree_in_a_graph_equals_eager():
    dev = _cuda()
    xs, xts, xps, _ = _card_tree(dev, 2 * tk.MAX_SEGMENTS + 3, seed=5)
    dt = torch.tensor(0.45, device=dev)
    want = tk.mixing_p2p_tree(xs, xts, xps, dt, **ACID)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.mixing_p2p_tree(xs, xts, xps, dt, **ACID)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tk.mixing_p2p_tree(xs, xts, xps, dt, **ACID)
    graph.replay()
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert all(torch.equal(a, b) for a, b in zip(w, g))


@pytest.mark.gpu
def test_cuda_launch_error_raises(monkeypatch):
    dev = _cuda()
    x = torch.ones(1000, device=dev)
    dt = torch.tensor(0.45, device=dev)
    monkeypatch.setattr(tk, "CHUNK", tk.CHUNK // 2)  # a table it refuses
    before = tk.mixing_p2p.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.mixing_p2p(x, x, x, dt, **ACID)
    assert tk.mixing_p2p.launches == before
