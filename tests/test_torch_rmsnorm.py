"""Port parity for the fused RMSNorm: the port's plain version equals the JAX
package's oracle and its Pallas kernel (interpret mode) on the JAX kernel
tests' shapes; on a card the hand kernel matches the plain version.  And
the model layer ``models.layers.rmsnorm`` (the one the models call, with
its own rounding) equals the JAX layer.

Tolerances: f32 atol 1e-5 (the JAX package's kernel test; the sums of
squares run in another order), bf16 atol 2e-2 (the JAX package's): even
against the JAX oracle, which rounds once at the end as the port does, a
few values land one bf16 ulp apart (2 of 131,072 at (128, 1024)), because
the f32 sums round differently before the last cast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm_2d as j_kernel
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_ref
from repro.models.layers import rmsnorm as j_layer
from repro_torch.kernels.rmsnorm import kernel as t_kernel
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.layers import rmsnorm as t_layer

SHAPES = [(64, 512, "float32"), (128, 1024, "bfloat16"),
          (130, 768, "float32"), (1, 256, "float32")]
# D not a multiple of the kernel's vector width (7), and one in each of its
# size classes past the warp's (1000 at f32 is still a warp's; 8192 a
# block's; 16384 the long class)
WIDE_SHAPES = [(t, d, dtype) for t, d in ((3, 7), (5, 1000), (4, 8192),
                                          (2, 16384))
               for dtype in ("float32", "bfloat16")]


def _inputs(t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, d)).astype(np.float32),
            0.1 * rng.normal(size=(d,)).astype(np.float32))


def _as(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("t,d,dtype", SHAPES + WIDE_SHAPES)
def test_plain_matches_jax_oracle_and_kernel(t, d, dtype):
    x, sc = _inputs(t, d, seed=t + d)
    out = rmsnorm_ref(_as(x, dtype), _as(sc, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == (t, d)
    jx, jsc = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, sc))
    want = np.asarray(j_ref(jx, jsc), np.float32)
    kern = np.asarray(j_kernel(jx, jsc, interpret=True), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), kern, atol=1e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2)
        np.testing.assert_allclose(out.float().numpy(), kern, atol=2e-2)


def test_op_any_leading_dims_and_unit_rms():
    x, _ = _inputs(24, 512, seed=1)
    x = 5.0 * torch.from_numpy(x).reshape(2, 3, 4, 512)
    out = rmsnorm(x, torch.zeros(512))
    assert out.shape == x.shape
    torch.testing.assert_close(out, rmsnorm_ref(x, torch.zeros(512)))
    rms = out.pow(2).mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms), atol=1e-3,
                               rtol=0.0)
    assert torch.equal(rmsnorm(x, torch.zeros(512), backend="ref"), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layer_matches_jax_layer(dtype):
    """``inv`` rounded to x's dtype before it multiplies (the JAX layer's
    rounding, not the kernel's)."""
    x, sc = _inputs(6, 256, seed=2)
    x = x.reshape(2, 3, 256)
    out = t_layer(_as(x, dtype), _as(sc, dtype), 1e-6)
    want = np.asarray(j_layer(jnp.asarray(x, getattr(jnp, dtype)),
                              jnp.asarray(sc, getattr(jnp, dtype)), 1e-6),
                      np.float32)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_kernel_refuses_cpu_tensors():
    x, sc = _inputs(4, 256)
    before = t_kernel.rmsnorm_2d.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_kernel.rmsnorm_2d(torch.from_numpy(x), torch.from_numpy(sc))
    assert t_kernel.rmsnorm_2d.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,dtype", SHAPES + WIDE_SHAPES + [
    (8192, 768, "float32"), (8192, 768, "bfloat16"),
    (8192, 1024, "bfloat16"), (64, 8192, "float32"), (16, 16384, "bfloat16"),
    (4, 1001, "float32"), (2, 8193, "bfloat16")])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_kernel_matches_plain(t, d, dtype, offset):
    """On the card, also on a view that starts ``offset`` elements past a
    16-byte boundary (its out starts as far past one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    x, sc = _inputs(t, d, seed=5)
    buf = torch.zeros(t * d + offset, dtype=getattr(torch, dtype),
                      device="cuda")
    tx = buf[offset:].view(t, d)
    tx.copy_(_as(x, dtype))
    tsc = _as(sc, dtype).cuda()
    before = t_kernel.rmsnorm_2d.launches
    out = t_kernel.rmsnorm_2d(tx, tsc)
    torch.cuda.synchronize()
    assert t_kernel.rmsnorm_2d.launches == before + 1
    assert out.shape == (t, d) and out.is_contiguous()
    assert out.data_ptr() % 16 == tx.data_ptr() % 16
    ref = rmsnorm_ref(tx, tsc)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0.0)
