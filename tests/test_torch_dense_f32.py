"""The f32 weight products (``kernels/dense_f32``): the dispatch rule, the
plain path, the operand layouts the kernel reads, the ``dense`` counter,
the kernel's shared-memory block maps, and its 3xTF32 arithmetic
emulated on the CPU; on a card the kernel itself.

On the CPU ``dense(x, w)`` is ``x @ w``, bit for bit under
``vmap(grad_and_value)``; ``gemm`` (the ``_Gemm`` op, the plain version
under its ``vmap`` rule and backward) equals ``x @ w`` there within 1e-6
of the largest gradient, both under ``vmap(grad_and_value)`` and under
``lm_grad_fn``'s plain autograd over a vmapped forward.

The emulation: hi = tf32(x) by bit operations ((bits + 0x1000) &
~0x1fff, cvt.rna's rounding), lo = x - hi in f32 read with its low 13
bits dropped, every 8-deep step lo.hi, hi.lo, hi.hi in the kernel's
order, each step's sum rounded to f32 and each 32-deep step's partial sum
added to the f32 accumulator.  Held against f64 at reduced shapes: no
worse than 4x numpy's f32 product, where TF32 alone (hi.hi) is over 20x
worse.  Errors are max |c - c64| / (|A| |B|) elementwise.

On a card (``gpu``-marked): the kernel against an f64 product at each
shape class of the two LM cells (ragged N 576 / 16,128 / 152,064, K
152,064, every operand majorness, batch 4, a strided batch, a shared
operand), its error no worse than 4x cuBLAS FFMA's against the same f64;
reduced Qwen3 and Kanana-2 blocks' ``lm_grad_fn`` gradients through the
kernel against the ``matmul`` path within 1e-4 of the tree's largest
gradient (the repo's f32 LM gradient tolerance).

``chip_smoke.py``'s ``weight_products``, which each f32 LM phase on the
card holds the kernel's launches to, against the ``dense`` calls that
reach 64 rows in a CPU forward or loss of the reduced zoo and Kanana-2.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch.analysis.tracing import SpanTracer
from repro_torch.kernels.dense_f32 import kernel as dk
from repro_torch.kernels.dense_f32 import ops

GEMM_TOL = 1e-6
# a reduced Kanana-2 block (tests/test_torch_mla_moe.py's size)
KANANA_SMALL = dict(hidden_size=256, num_attention_heads=4, kv_lora_rank=32,
                    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                    intermediate_size=512, moe_intermediate_size=64,
                    router_experts=16, n_routed_experts=4,
                    num_experts_per_tok=4, vocab_size=500,
                    num_hidden_layers=3)
LM_GRAD_TOL = 1e-4
CUBLAS_RATIO = 4.0


def _fake(dtype, cuda, shape):
    return SimpleNamespace(dtype=dtype, is_cuda=cuda, shape=shape,
                           dim=lambda: len(shape))


@pytest.mark.parametrize("xdt,wdt,cuda,rows,wdim,want", [
    (torch.float32, torch.float32, True, 64, 2, True),
    (torch.float32, torch.float32, True, 4096, 2, True),
    (torch.float32, torch.float32, True, 63, 2, False),      # decode rows
    (torch.float32, torch.float32, False, 4096, 2, False),   # the CPU
    (torch.bfloat16, torch.bfloat16, True, 4096, 2, False),  # bf16
    (torch.float32, torch.bfloat16, True, 4096, 2, False),
    (torch.float32, torch.float32, True, 4096, 3, False),    # not a matrix
])
def test_dispatch_rule(xdt, wdt, cuda, rows, wdim, want):
    x = _fake(xdt, cuda, (2, rows // 2, 8) if rows % 2 == 0 else (rows, 8))
    w = _fake(wdt, cuda, (8,) * wdim)
    assert ops.on_kernel(x, w) is want


def _loss(mm):
    """A small LM-like loss: two products, a tied head (w^T)."""
    def f(p, x):
        h = torch.tanh(mm(x, p["w"][1]))
        h = mm(h, p["w2"])
        return (mm(h, p["tok"].T) ** 2).mean()
    return f


def _params(gen, workers=3):
    return {"w": torch.randn(workers, 2, 16, 24, generator=gen),
            "w2": torch.randn(workers, 24, 16, generator=gen),
            "tok": torch.randn(workers, 40, 16, generator=gen)}


def test_plain_path_is_matmul_bit_for_bit_under_vmap_grad():
    gen = torch.Generator().manual_seed(0)
    p, x = _params(gen), torch.randn(3, 2, 70, 16, generator=gen)
    ga, va = vmap(grad_and_value(_loss(ops.dense)))(p, x)
    gb, vb = vmap(grad_and_value(_loss(lambda a, b: a @ b)))(p, x)
    assert torch.equal(va, vb)
    assert all(torch.equal(ga[k], gb[k]) for k in gb)


def _lm_grad(mm, p, x):
    """``lm_grad_fn``'s form: plain autograd over a vmapped forward."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    losses = vmap(_loss(mm))(leaves, x)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    return dict(zip(leaves, grads)), losses.detach()


@pytest.mark.parametrize("form", ["vmap_grad", "autograd_over_vmap"])
def test_gemm_op_equals_matmul(form):
    gen = torch.Generator().manual_seed(1)
    p, x = _params(gen), torch.randn(3, 2, 70, 16, generator=gen)
    if form == "vmap_grad":
        run = lambda mm: vmap(grad_and_value(_loss(mm)))(p, x)  # noqa: E731
    else:
        run = lambda mm: _lm_grad(mm, p, x)  # noqa: E731
    ga, va = run(ops.gemm)
    gb, vb = run(lambda a, b: a @ b)
    torch.testing.assert_close(va, vb, rtol=GEMM_TOL, atol=0)
    top = max(g.abs().max() for g in gb.values())
    for k in gb:
        assert ga[k].shape == gb[k].shape
        assert (ga[k] - gb[k]).abs().max() <= GEMM_TOL * top, k
    # the tied head's gradient comes in tok's row-major layout
    assert ga["tok"].is_contiguous()


def test_gemm_unbatched_weight_and_second_derivative():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 66, 8, generator=gen)
    w = torch.randn(8, 5, generator=gen)
    f = lambda mm: lambda xx, ww: (mm(xx, ww) ** 3).sum()  # noqa: E731
    ga = vmap(torch.func.grad(f(ops.gemm), argnums=1), (0, None))(x, w)
    gb = vmap(torch.func.grad(f(lambda a, b: a @ b), argnums=1),
              (0, None))(x, w)
    torch.testing.assert_close(ga, gb, rtol=GEMM_TOL, atol=1e-5)
    h = torch.func.grad(lambda ww: torch.func.grad(f(ops.gemm), argnums=1)(
        x[0], ww).sum())(w)
    hb = torch.func.grad(lambda ww: torch.func.grad(
        f(lambda a, b: a @ b), argnums=1)(x[0], ww).sum())(w)
    torch.testing.assert_close(h, hb, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ layouts
def _aligned(*shape):
    return torch.empty(*shape)   # the CPU allocator aligns to 64 bytes


@pytest.mark.parametrize("case,k_dim,want", [
    ("a row-major", 2, (True, 12, 0)),
    ("a transposed", 2, (False, 20, 0)),
    ("b row-major", 1, (False, 20, 0)),
    ("b transposed (tok.T)", 1, (True, 12, 0)),
    ("stacked slice", 1, (False, 20, 3 * 12 * 20)),
    ("expanded batch", 1, (False, 20, 0)),
    ("ld off 16 bytes", 2, None),
    ("no unit stride", 2, None),
    ("misaligned", 2, None),
    ("one row", 2, (True, 12, 0)),
])
def test_operand_layout(case, k_dim, want):
    t = {
        "a row-major": lambda: _aligned(1, 20, 12),
        "a transposed": lambda: _aligned(1, 12, 20).transpose(1, 2),
        "b row-major": lambda: _aligned(1, 12, 20),
        "b transposed (tok.T)": lambda: _aligned(1, 20, 12).transpose(1, 2),
        "stacked slice": lambda: _aligned(4, 3, 12, 20)[:, 1],
        "expanded batch": lambda: _aligned(12, 20).expand(4, 12, 20),
        "ld off 16 bytes": lambda: _aligned(1, 20, 14)[..., :12],
        "no unit stride": lambda: _aligned(1, 20, 24)[..., ::2],
        "misaligned": lambda: _aligned(1, 20 * 12 + 1)[:, 1:].view(1, 20, 12),
        "one row": lambda: _aligned(1, 1, 12),
    }[case]()
    assert dk.operand_layout(t, k_dim) == want


# ------------------------------------------------------------ counter
def test_dense_counter_samples():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 40, 8, generator=gen, requires_grad=True)
    w = torch.randn(8, 6, generator=gen)
    tracer = SpanTracer("t")
    with tracer.activate():
        ops.dense(x, w).sum().backward()     # x @ w: 3 products
        with torch.no_grad():
            ops.dense(x, w)                  # forward only
        ops.gemm(x.detach(), w)              # the op, on the CPU: matmul
    tracer.resolve()
    got = [e["args"] for e in tracer.to_dict()["traceEvents"]
           if e.get("ph") == "C" and e["name"] == "dense"]
    flops = 2.0 * 80 * 8 * 6
    assert got == [
        {"kernel_products": 0, "kernel_flops": 0.0, "matmul_products": 3,
         "matmul_flops": 3 * flops},
        {"kernel_products": 0, "kernel_flops": 0.0, "matmul_products": 1,
         "matmul_flops": flops},
        {"kernel_products": 0, "kernel_flops": 0.0, "matmul_products": 1,
         "matmul_flops": flops}]


# ------------------------------------------------ the kernel's block maps
def _kmajor_at(mn, k):
    return mn * 128 + ((((k >> 2) ^ (mn & 7))) << 4) + (k & 3) * 4


def _mnmajor_at(mn, k):
    return (mn >> 5) * 4096 + k * 128 + ((((mn & 31) >> 2) ^ (k & 7)) << 4) \
        + (mn & 3) * 4


def _banks_free(addrs, width):
    """A warp access of ``width``-byte words at ``addrs`` (32 lanes) in
    as few wavefronts as its bytes need: each phase of 128 bytes touches
    every bank once."""
    per = 128 // width
    for p in range(0, 32, per):
        banks = [((a % 128) // 4 + i) % 32 for a in addrs[p:p + per]
                 for i in range(width // 4)]
        if len(set(banks)) != len(banks):
            return False
    return True


def test_split_block_maps():
    # MN-major B: thread tid takes columns 4j .. 4j + 3, depths 4q .. 4q + 3
    seen = set()
    for warp in range(8):
        lanes = [warp * 32 + lane for lane in range(32)]
        js = [8 * ((t >> 3) & 3) + (t & 7) for t in lanes]
        qs = [(t & 7) ^ (t >> 5) for t in lanes]
        seen.update(zip(js, qs))
        for e in range(4):   # the 4 loads, 16 bytes, raw MN-major tile
            assert _banks_free([_mnmajor_at(4 * j, 4 * q + e)
                                for j, q in zip(js, qs)], 16)
        for i in range(4):   # the 4 stores each of hi and lo, K-major
            assert _banks_free([_kmajor_at(4 * j + i, 4 * q)
                                for j, q in zip(js, qs)], 16)
    assert seen == {(j, q) for j in range(32) for q in range(8)}
    # K-major B: thread c, column c % 128, depths 4 (c / 128) ..
    for r in range(4):
        for warp in range(8):
            cs = [r * 256 + warp * 32 + lane for lane in range(32)]
            assert _banks_free([_kmajor_at(c % 128, 4 * (c // 128))
                                for c in cs], 16)
    # A fragments: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), every
    # warp of both warpgroups; MN-major with rows g >= 4 reading t + 4
    # first
    for wg in range(2):
        for warp in range(4):
            for kk in range(4):
                for row8 in (0, 8):
                    for first in (True, False):
                        km, mn = [], []
                        for lane in range(32):
                            g, t = lane // 4, lane % 4
                            r = wg * 64 + warp * 16 + g + row8
                            swap = g >= 4
                            k = 8 * kk + t + (4 if first == swap else 0)
                            km.append(_kmajor_at(r, 8 * kk + t
                                                 + (0 if first else 4)))
                            mn.append(_mnmajor_at(r, k))
                        assert _banks_free(km, 4) and _banks_free(mn, 4)


# ---------------------------------------------- the arithmetic, emulated
def _tf32_rna(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate(a: np.ndarray, b: np.ndarray, three: bool = True
             ) -> np.ndarray:
    """The kernel's arithmetic on a (M, K) @ b (K, N), f32 in and out."""
    m, k = a.shape
    n = b.shape[1]
    pad = -k % 32
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    ahi, bhi = _tf32_rna(a), _tf32_rna(b)
    alo = _tf32_trunc(a - ahi)
    blo = _tf32_trunc(b - bhi)
    pairs = [(alo, bhi), (ahi, blo), (ahi, bhi)] if three else [(ahi, bhi)]
    acc = np.zeros((m, n), np.float32)
    for k0 in range(0, k + pad, 32):
        part = np.zeros((m, n), np.float32)
        for kk in range(k0, k0 + 32, 8):
            for x, y in pairs:   # one wgmma: 8 exact products and part
                s = x[:, kk:kk + 8].astype(np.float64) \
                    @ y[kk:kk + 8].astype(np.float64)
                part = (part.astype(np.float64) + s).astype(np.float32)
        acc = acc + part          # f32 adds, rounded to nearest
    return acc


def _err(c, a, b) -> float:
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    return float((np.abs(c.astype(np.float64) - a64 @ b64)
                  / (np.abs(a64) @ np.abs(b64))).max())


@pytest.mark.parametrize("m,n,k", [(64, 96, 1000), (40, 72, 72),
                                   (16, 24, 4096)])
def test_3xtf32_arithmetic_emulated(m, n, k):
    rng = np.random.default_rng(m + n + k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 1e-3).astype(np.float32)
    f32 = _err(a @ b, a, b)
    three = _err(_emulate(a, b), a, b)
    tf32 = _err(_emulate(a, b, three=False), a, b)
    assert three <= CUBLAS_RATIO * f32, (three, f32)
    assert tf32 >= 20 * f32, (tf32, f32)


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operand(gen, dev, batch, rows, cols, unit_last, shared=False,
             stacked=False):
    """(batch, rows, cols), the unit stride on the last axis or the one
    before; ``shared`` one matrix expanded over the batch, ``stacked`` a
    slice of a (batch, 3, ...) stack (a batch stride of 3 matrices)."""
    lead = (1,) if shared else (batch, 3) if stacked else (batch,)
    shape = (rows, cols) if unit_last else (cols, rows)
    t = torch.randn(*lead, *shape, generator=gen, device=dev)
    if stacked:
        t = t[:, 1]
    if not unit_last:
        t = t.transpose(-1, -2)
    return t.expand(batch, rows, cols)


SHAPES = [  # (label, batch, M, N, K, a K-major, b K-major, extra)
    ("w_dkv fwd", 4, 256, 576, 2048, True, False, {}),
    ("Kanana head fwd", 4, 128, 16128, 2048, True, False, {}),
    ("Qwen3 tied head fwd", 4, 128, 152064, 1024, True, True, {}),
    ("Qwen3 head dX", 4, 256, 256, 152064, True, False, {}),
    ("dW", 4, 1024, 576, 1024, False, False, {}),
    ("dX", 4, 1024, 1024, 576, True, True, {}),
    ("A M-major, B K-major", 4, 1100, 1024, 256, False, True, {}),
    ("stacked weight", 4, 200, 3072, 1024, True, False, {"stacked": True}),
    ("shared weight", 4, 130, 200, 72, True, False, {"shared": True}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("label,batch,m,n,k,akm,bkm,extra", SHAPES)
def test_kernel_against_f64(card, label, batch, m, n, k, akm, bkm, extra):
    gen = torch.Generator(device=card).manual_seed(m + n + k)
    a = _operand(gen, card, batch, m, k, akm)
    b = _operand(gen, card, batch, k, n, not bkm, **extra)
    before = dk.gemm_3xtf32.launches
    c = dk.gemm_3xtf32(a, b)
    torch.cuda.synchronize()
    assert dk.gemm_3xtf32.launches == before + 1
    want = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    err = ((c.double() - want).abs() / scale).max().item()
    lib = ((torch.matmul(a, b).double() - want).abs() / scale).max().item()
    assert err <= CUBLAS_RATIO * lib, (label, err, lib)


def _block_grads(cfg_name, mm_on_kernel: bool):
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.transformer import Model, lm_grad_fn
    dev = torch.device("cuda")
    if cfg_name == "qwen3":
        from repro_torch.configs import get_config
        cfg = get_config("qwen3-0.6b", reduced=True)
    else:
        from perfbench.conftest import HERE
        from perfbench.models import mla_moe
        kcfg = json.loads((HERE / "configs/kanana2_30b_a3b.json")
                          .read_text())
        kcfg.update(KANANA_SMALL)
        cfg = mla_moe.model_config(kcfg)
    model = Model(cfg)
    ps = [model.init(torch.Generator(device=dev).manual_seed(i))
          for i in range(2)]
    x = tree_map(lambda *a: torch.stack(a), *ps)

    class Stream:
        def sample_workers(self, gen, n):
            t = torch.randint(0, cfg.vocab_size, (n, 2, 129),
                              generator=gen, device=dev)
            return {"inputs": t[..., :-1], "labels": t[..., 1:]}

    rule = ops.on_kernel
    if not mm_on_kernel:
        ops.on_kernel = lambda x, w: False
    try:
        losses, grads = lm_grad_fn(model, Stream())(
            x, torch.Generator(device=dev).manual_seed(9),
            torch.arange(2, device=dev))
    finally:
        ops.on_kernel = rule
    return losses, tree_leaves(grads)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_name", ["qwen3", "kanana2"])
def test_block_gradients_through_the_kernel(card, cfg_name):
    before = dk.gemm_3xtf32.launches
    lk, gk = _block_grads(cfg_name, True)
    launched = dk.gemm_3xtf32.launches - before
    lm, gm = _block_grads(cfg_name, False)
    assert launched > 0 and dk.gemm_3xtf32.launches - before == launched
    torch.testing.assert_close(lk, lm, rtol=LM_GRAD_TOL, atol=0)
    top = max(g.abs().max().item() for g in gm)
    worst = max((a - b).abs().max().item() for a, b in zip(gk, gm))
    assert worst <= LM_GRAD_TOL * top, (worst, top)


# ------------------------------------ chip_smoke.py's count of products
def _model(name):
    from repro_torch.configs import get_config
    if name != "kanana2":
        return get_config(name, reduced=True)
    from perfbench.conftest import HERE
    from perfbench.models import mla_moe
    kcfg = json.loads((HERE / "configs/kanana2_30b_a3b.json").read_text())
    kcfg.update(KANANA_SMALL)
    return mla_moe.model_config(kcfg)


@pytest.mark.parametrize("name,batch,seq,mode", [
    ("nano-lm", 2, 40, "loss"),
    ("qwen3-0.6b", 1, 64, "loss"),
    ("qwen3-0.6b", 1, 63, "forward"),
    ("qwen3-0.6b", 2, 40, "decode"),
    ("deepseek-v3-671b", 2, 40, "loss"),
    ("deepseek-v3-671b", 2, 32, "loss"),
    ("deepseek-v3-671b", 2, 32, "decode"),
    ("arctic-480b", 2, 40, "forward"),
    ("mamba2-780m", 2, 64, "loss"),
    ("recurrentgemma-9b", 2, 40, "loss"),
    ("kanana2", 2, 40, "loss"),
    ("kanana2", 2, 31, "decode"),
])
def test_weight_products_counts_the_models_dense_calls(
        monkeypatch, name, batch, seq, mode):
    """``chip_smoke.weight_products``, which each f32 LM phase on the card
    holds ``gemm_3xtf32``'s launches to, counts from the config what the
    model hands ``dense`` with rows enough for the kernel: the MTP block's
    on seq - 1 rows (at (2, 32) 62, too few); a decode step's on its batch
    rows, MLA's k and v up-projections on the whole cache's."""
    import chip_smoke
    from repro_torch.models import attention, layers
    from repro_torch.models.transformer import Model
    seen = []

    def counting(x, w):
        seen.append(x.shape[:-1].numel() >= ops.MIN_ROWS)
        return x @ w

    monkeypatch.setattr(attention, "dense", counting)
    monkeypatch.setattr(layers, "dense", counting)
    cfg = _model(name)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        if mode == "loss":
            model.loss(params, {"inputs": toks[:, :-1],
                                "labels": toks[:, 1:]})
        elif mode == "forward":
            model.forward(params, toks[:, :-1])
        else:
            model.decode_step(params, toks[:, :1], 3,
                              model.init_cache(batch, seq, device="cpu"))
    want = chip_smoke.weight_products(
        cfg, batch, 1 if mode == "decode" else seq, loss=mode == "loss",
        cache=seq if mode == "decode" else 0)
    assert want == sum(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ld off 16 bytes", "no unit stride"])
def test_unreadable_layout_raises_on_the_card(card, case):
    """On the card every product launches the kernel: an operand it
    cannot read raises, and never takes ``matmul`` instead."""
    gen = torch.Generator(device=card).manual_seed(4)
    if case == "ld off 16 bytes":     # rows 30 floats apart: 120 bytes
        x = torch.randn(70, 30, generator=gen, device=card)[:, :14]
    else:
        x = torch.randn(70, 28, generator=gen, device=card)[:, ::2]
    w = torch.randn(14, 16, generator=gen, device=card)
    before = dk.gemm_3xtf32.launches
    with pytest.raises(ValueError, match="cannot read strides"):
        ops.dense(x, w)
    assert dk.gemm_3xtf32.launches == before
