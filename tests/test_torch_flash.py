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
"""
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,hd,causal,window", SHAPES + [DEAD_ROWS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(s, t, hd, causal, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(3, s, t, hd, seed=7))
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
    assert torch.all(out[:, ~live] == 0)
