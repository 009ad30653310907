"""Port parity for flash attention: the port's plain version equals the JAX
package's oracle and its Pallas kernel (interpret mode), in the (BH, S, hd)
layout and through the (B, S, H, hd) GQA op; a model with
``attention_impl="pallas"`` equals the JAX interpret-mode forward; on a card
the hand kernel matches the plain version.

A row with no live column (a window without the causal mask) is the one
place where kernel and oracle differ by design: both kernels write 0, both
oracles the mean of v.  Kernel results are compared on live rows and the 0
is pinned as an identity.

Tolerances: atol 2e-5, rtol 1e-4 at f32, the JAX package's own
kernel-vs-oracle tolerance (``tests/test_kernels.py``); oracle vs oracle
rtol 1e-5 (the same f32 einsums and softmax, summed in another order);
models max|dlogits| / max|logits| < 2e-4 (``tests/test_flash_in_model.py``);
bf16 atol 3e-2 against the f32-computed oracle, as the JAX package holds it.

The card kernel's arithmetic is emulated here on the CPU and held against
the JAX oracle at the same tolerances: at f32, 3xTF32 (each operand split
into hi = tf32(x) and lo = tf32(x - hi), a.b taken as lo.hi + hi.lo +
hi.hi in 8-deep steps with f32 accumulation); at bf16, P rounded to bf16
before P V.  Both run the kernel's online softmax over 64-column tiles in
log2 units (the scale times log2 e, one f32 constant, then 2^x).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as j_kernel
from repro.kernels.flash_attention.ops import flash_attention as j_op
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     attention_ref)
from repro_torch.models.transformer import Model

TOL = dict(atol=2e-5, rtol=1e-4)
SHAPES = [  # the JAX package's kernel tests: (S, T, hd, causal, window)
    (128, 128, 64, True, None),
    (256, 256, 64, True, None),
    (256, 256, 128, False, None),
    (200, 200, 64, True, 64),       # unaligned seq + window
    (130, 384, 64, False, None),    # cross attention shape
]
# a window without the causal mask: rows 163.. see no column
DEAD_ROWS = (200, 100, 64, False, 64)


def _qkv(bh, s, t, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, n, hd)).astype(np.float32)
            for n in (s, t, t)]


def _live(s, t, causal, window):
    return attention_mask(s, t, causal=causal, window=window).any(1).numpy()


@pytest.mark.parametrize("s,t,hd,causal,window", SHAPES + [DEAD_ROWS])
def test_plain_matches_jax_oracle_and_kernel(s, t, hd, causal, window):
    q, k, v = _qkv(2, s, t, hd, seed=s + t)
    kw = dict(causal=causal, window=window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = attention_ref(tq, tk, tv, **kw).numpy()
    np.testing.assert_allclose(ref, np.asarray(j_ref(jq, jk, jv, **kw)),
                               rtol=1e-5, atol=1e-6)
    jk_out = np.asarray(j_kernel(jq, jk, jv, interpret=True, **kw))
    live = _live(s, t, causal, window)
    np.testing.assert_allclose(ref[:, live], jk_out[:, live], **TOL)
    # the kernel's 0 on a row with no live column
    assert np.all(jk_out[:, ~live] == 0)
    assert live.all() == ((s, t, hd, causal, window) != DEAD_ROWS)


@pytest.mark.parametrize("h,kv,window", [(4, 2, None), (4, 1, 48),
                                         (4, 4, None)])
def test_gqa_op_matches_jax_op(h, kv, window):
    rng = np.random.default_rng(h * 10 + kv)
    b, s, hd = 2, 96, 64
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window=window)
    assert out.shape == (b, s, h, hd)
    want = j_op(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                force_pallas=True, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    forced = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=window, backend="ref")
    assert torch.equal(forced, out)


def test_plain_bf16_matches_jax():
    q, k, v = _qkv(1, 256, 256, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = attention_ref(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jout = j_kernel(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), atol=3e-2)


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None),
                                         ("nano-lm", 32)])
def test_pallas_model_matches_jax_interpret_forward(arch, window):
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if window:
        jcfg, tcfg = jcfg.windowed(window), tcfg.windowed(window)
    jcfg = jcfg.with_updates(attention_impl="pallas")
    tcfg = tcfg.with_updates(attention_impl="pallas")
    jparams = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 96)).astype(np.int32)
    jl, _, _ = JModel(jcfg).forward(jparams, jnp.asarray(toks))
    tl, _, _ = Model(tcfg).forward(params_from_jax(jparams, device="cpu"),
                                   torch.from_numpy(toks))
    jl = np.asarray(jl)
    scale = np.abs(jl).max() + 1e-6
    assert np.abs(tl.numpy() - jl).max() / scale < 2e-4


def test_kernel_refuses_gradients_and_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 64, 64))
    before = t_kernel.flash_attention_bhsd.launches
    with pytest.raises(RuntimeError, match="no backward"):
        t_kernel.flash_attention_bhsd(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_kernel.flash_attention_bhsd(q.detach(), k, v)
    assert t_kernel.flash_attention_bhsd.launches == before
    # the CPU op takes the plain version, which autograd differentiates
    qg = q.detach().reshape(2, 64, 1, 64).requires_grad_()
    out = flash_attention(qg, k.reshape(2, 64, 1, 64),
                          v.reshape(2, 64, 1, 64))
    out.sum().backward()
    assert qg.grad is not None


@pytest.mark.parametrize("hd", [32, 56, 100, 200])
def test_head_dim_padding_is_exact_on_the_plain_version(hd):
    """The wrapper's padding: zero columns up to the next instantiation,
    the real hd's scale, the output cut back, equal to attention on the
    inputs as they are (within 1e-6: only the order of the sums moves)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 70, 70, hd, seed=hd))
    qp, kp, vp = t_kernel.pad_head_dim(q, k, v)
    hp = t_kernel.padded_head_dim(hd)
    assert hp in t_kernel.HEAD_DIMS and hp > hd
    assert qp.shape == (3, 70, hp) and kp.shape == vp.shape == (3, 70, hp)
    assert all(torch.equal(a[..., :hd], b) and torch.all(a[..., hd:] == 0)
               for a, b in ((qp, q), (kp, k), (vp, v)))
    for causal, window in ((True, None), (True, 48), (False, None)):
        got = attention_ref(qp, kp, vp, causal=causal, window=window,
                            scale=hd ** -0.5)[..., :hd]
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,h,kv", [(1, 16, 1), (1, 4, 4), (2, 4, 2)])
def test_op_hands_the_kernel_contiguous_inputs(monkeypatch, b, h, kv):
    """The (B, S, H, hd) op flattens heads for the kernel: at B == 1 the
    transposed reshape is a strided view, which the kernel refuses; the
    op hands it contiguous (BH, S, hd) tensors at every B."""
    from repro_torch.kernels.flash_attention import ops
    seen = []

    def kernel(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return attention_ref(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_bhsd", kernel)
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, x: "cuda")
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(b, 40, h, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, 40, kv, 32))
                             .astype(np.float32)) for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=True, window=16)
    assert seen == [True]
    want = flash_attention(q, k, v, causal=True, window=16, backend="ref")
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_head_dims_of_the_kernel():
    """64, 128 and 256 run as they are (no copy); above 256 raises."""
    q = torch.zeros(1, 4, 128)
    assert t_kernel.pad_head_dim(q, q, q)[0] is q
    assert [t_kernel.padded_head_dim(h) for h in (1, 64, 65, 128, 129,
                                                  256)] \
        == [64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="257 > 256"):
        t_kernel.padded_head_dim(257)


# ------------------------------------------- the card kernel's arithmetic
KBK = 64  # the kernel's k tile


def _tf32_rna(x):
    """cvt.rna.tf32.f32: round the f32 pattern to 10 mantissa bits, ties
    away from zero (add half an ulp of tf32 to the magnitude, truncate)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -(2 ** 31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | sign).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _mm_3xtf32(a, b):
    """a (..., M, K) @ b (..., K, N) as the kernel's tensor-core steps take
    it: per 8-deep block lo.hi, then hi.lo, then hi.hi, accumulated in
    f32."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    d = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c in range(0, a.shape[-1], 8):
        blk = slice(c, c + 8)
        for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            d = d + x[..., blk] @ y[..., blk, :]
    return d


def _emulate(q, k, v, *, causal, window, mode):
    """The kernel's online softmax over KBK-column tiles, in f32; ``mode``
    '3xtf32' (f32 inputs) or 'bf16' (P rounded to bf16 before P V).  Rows
    with no live column come out 0."""
    s_len, t_len, hd = q.shape[1], k.shape[1], q.shape[2]
    scale2 = (torch.tensor(hd ** -0.5, dtype=torch.float32)
              * torch.tensor(math.log2(math.e), dtype=torch.float32))
    qf, kf, vf = q.float(), k.float(), v.float()
    mask = attention_mask(s_len, t_len, causal=causal, window=window)
    m = torch.full(q.shape[:2] + (1,), -1e30)
    l = torch.zeros(q.shape[:2] + (1,))
    acc = torch.zeros(q.shape[:2] + (hd,))
    for k0 in range(0, t_len, KBK):
        cols = slice(k0, k0 + KBK)
        kt = kf[:, cols].transpose(1, 2)
        s = _mm_3xtf32(qf, kt) if mode == "3xtf32" else qf @ kt
        s = torch.where(mask[:, cols], s * scale2, -1e30)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        # a row not yet alive subtracts 0: its p and corr come out 0
        mu = torch.where(m_cur > -5e29, m_cur, 0.0)
        p = torch.exp2(s - mu)
        corr = torch.exp2(m - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        if mode == "3xtf32":
            pv = _mm_3xtf32(p, vf[:, cols])
        else:
            pv = p.to(torch.bfloat16).float() @ vf[:, cols]
        acc = acc * corr + pv
        m = m_cur
    return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)


def _within_bf16_bound(out, ref, mass):
    """|out - ref| <= 2^-7 |ref| + 2^-8 mass, mass = sum_c p_c |v_c|: the
    first-order bound of bf16's three roundings between the kernel and the
    oracle (P before P V, both outputs), each at most 2^-8 relative."""
    out, ref, mass = out.float(), ref.float(), mass.float()
    return bool(((out - ref).abs()
                 <= 2.0 ** -7 * ref.abs() + 2.0 ** -8 * mass).all())


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -20, 3.0],
                     dtype=torch.float32)
    want = [1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0, 3.0]
    assert _tf32_rna(x).tolist() == want
    hi, lo = _split(torch.tensor([1.0 + 2 ** -15], dtype=torch.float32))
    assert hi.item() == 1.0 and lo.item() == 2 ** -15


@pytest.mark.parametrize("s,t,hd,causal,window", SHAPES + [DEAD_ROWS])
def test_3xtf32_emulation_meets_the_f32_gate(s, t, hd, causal, window):
    q, k, v = _qkv(2, s, t, hd, seed=s + t + 1)
    kw = dict(causal=causal, window=window)
    out = _emulate(*map(torch.from_numpy, (q, k, v)), mode="3xtf32",
                   **kw).numpy()
    want = np.asarray(j_ref(*map(jnp.asarray, (q, k, v)), **kw))
    live = _live(s, t, causal, window)
    np.testing.assert_allclose(out[:, live], want[:, live], **TOL)
    assert np.all(out[:, ~live] == 0)
    # plain TF32 (hi.hi alone) would not: the split is what meets the gate
    tq, tk = (_tf32_rna(torch.from_numpy(a)) for a in (q, k))
    one = torch.einsum("bsh,bth->bst", tq, tk)
    full = torch.einsum("bsh,bth->bst", *map(torch.from_numpy, (q, k)))
    assert (one - full).abs().max().item() > TOL["atol"] * 10


@pytest.mark.parametrize("s,t,hd,causal,window", SHAPES + [DEAD_ROWS])
def test_bf16_emulation_meets_the_bf16_gate(s, t, hd, causal, window):
    q, k, v = _qkv(2, s, t, hd, seed=s + t + 2)
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = _emulate(tq, tk, tv, mode="bf16", **kw)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_ref(jq, jk, jv, **kw), np.float32)
    live = _live(s, t, causal, window)
    np.testing.assert_allclose(out.float().numpy()[:, live], want[:, live],
                               atol=3e-2, rtol=0)
    mass = np.asarray(j_ref(*(x.astype(jnp.float32)
                              for x in (jq, jk, jnp.abs(jv))), **kw))
    assert _within_bf16_bound(out[:, live], torch.from_numpy(want[:, live]),
                              torch.from_numpy(mass[:, live]))
    assert np.all(out.float().numpy()[:, ~live] == 0)


# shapes that cross the kernel's q tile (64, 128 or 192 rows), k tile (32
# or 64 columns) and ring edges: (BH, S, T, hd, causal, window)
EDGE_SHAPES = [
    (3, 1, 1, 64, True, None),
    (3, 65, 65, 128, True, None),
    (3, 1000, 1000, 64, True, None),
    (3, 1000, 1000, 128, True, None),
    (3, 65, 1000, 128, False, None),     # T > S
    (3, 1000, 65, 64, False, None),      # T < S
    (3, 1000, 65, 128, True, None),      # T < S, causal
    (3, 1000, 1000, 64, True, 16),       # window shorter than a tile
    (3, 1000, 65, 128, False, 16),       # rows 80.. see no column
    (96, 1024, 1024, 64, True, None),    # BH 96
    # hd 256 (RecurrentGemma's local attention) and head dims padded to
    # the next instantiation: 32 (reduced nano-lm), 56 (DeepSeek-V3's MTP
    # block at full width)
    (3, 1000, 1000, 256, True, None),
    (3, 300, 300, 256, True, 128),
    (3, 65, 1000, 256, False, None),
    (3, 200, 200, 32, True, None),
    (3, 511, 511, 56, True, None),
    (2, 130, 384, 56, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,t,hd,causal,window",
                         [(3, *c) for c in SHAPES + [DEAD_ROWS]]
                         + EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(bh, s, t, hd, causal, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(bh, s, t, hd, seed=7))
    kw = dict(causal=causal, window=window)
    before = t_kernel.flash_attention_bhsd.launches
    out = t_kernel.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_kernel.flash_attention_bhsd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, **kw)
    live = torch.from_numpy(_live(s, t, causal, window)).cuda()
    tol = TOL if dtype == torch.float32 else dict(atol=3e-2, rtol=0.0)
    torch.testing.assert_close(out[:, live].float(), ref[:, live].float(),
                               **tol)
    if dtype == torch.bfloat16:
        mass = attention_ref(q.float(), k.float(), v.float().abs(), **kw)
        assert _within_bf16_bound(out[:, live], ref[:, live], mass[:, live])
    assert torch.all(out[:, ~live] == 0)
