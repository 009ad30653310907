"""RMSNorm's custom VJP in the port (``repro_torch.models.layers.rmsnorm``)
against ``jax.vjp`` of the JAX package's ``repro.models.layers.rmsnorm``
on the same numpy inputs: f32, bf16 and both mixed dtypes, leading
shapes of 1, 2 and 3 axes, a row of zeros (where eps decides).  Then the
transforms the models put it under: ``torch.func.vmap`` of
``torch.func.grad`` over workers, the meta device, and
``torch.utils.checkpoint``.

Tolerances: every bf16 output (out, gx, and gscale where the scale is
bf16) bit for bit JAX's — the backward is elementwise but for the f32
row dot and the f32 sum of the scale's gradient, which both packages take
in f32 before rounding; every f32 output within 1e-6 of its largest
magnitude (XLA and PyTorch sum the f32 reductions in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.layers import rmsnorm as j_rmsnorm
from repro_torch.models.layers import rmsnorm

F32_RTOL = 1e-6
D = 256
SHAPES = [(D,), (16, D), (4, 64, D), (2, 3, 4, D)]
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("float32", "bfloat16"), ("bfloat16", "float32")]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    scale = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    if len(shape) > 1:
        x.reshape(-1, shape[-1])[0] = 0.0     # a row where eps decides
    return x, scale, g


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The numpy f32 array rounded to ``dtype`` as JAX rounds it."""
    return torch.from_numpy(np.array(
        jnp.asarray(a, dtype).astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("xd,sd", DTYPES, ids=lambda d: d)
def test_vjp_matches_jax(xd, sd, shape):
    x, scale, g = _inputs(shape)
    jx, js, jg = (jnp.asarray(x, xd), jnp.asarray(scale, sd),
                  jnp.asarray(g, xd))
    jout, vjp = jax.vjp(j_rmsnorm, jx, js)
    jgx, jgs = vjp(jg)
    tx = _torch(x, xd).requires_grad_()
    ts = _torch(scale, sd).requires_grad_()
    out = rmsnorm(tx, ts)
    out.backward(_torch(g, xd))
    # each output in JAX's dtype: out and gx in x's, gscale in the scale's
    assert out.dtype == tx.grad.dtype == getattr(torch, xd)
    assert ts.grad.dtype == getattr(torch, sd)
    for want, got, dt in ((jout, out, xd), (jgx, tx.grad, xd),
                          (jgs, ts.grad, sd)):
        if dt == "bfloat16":
            np.testing.assert_array_equal(
                got.detach().float().numpy(),
                np.asarray(want.astype(jnp.float32)))
        else:
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=F32_RTOL * np.abs(want).max())
    assert bool(torch.isfinite(tx.grad).all())


def _loss(x, scale, g):
    return (rmsnorm(x, scale) * g).sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmap_of_grad_equals_single_calls(dtype):
    """Three workers' (x, scale) through ``vmap(grad)`` — as
    ``lm_grad_fn`` differentiates the stacked models — equal to a loop of
    single calls, bit for bit."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 8, D)).astype(np.float32))
    scale = torch.from_numpy(0.1 * rng.normal(size=(3, D)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 8, D)).astype(np.float32))
    x, scale, g = x.to(dtype), scale.to(dtype), g.to(dtype)
    gx, gs = torch.func.vmap(torch.func.grad(_loss, argnums=(0, 1)))(
        x, scale, g)
    for w in range(3):
        lx, ls = torch.func.grad(_loss, argnums=(0, 1))(x[w], scale[w],
                                                       g[w])
        assert torch.equal(gx[w], lx) and torch.equal(gs[w], ls)
    xa, sa = x[0].clone().requires_grad_(), scale[0].clone().requires_grad_()
    _loss(xa, sa, g[0]).backward()
    assert torch.equal(xa.grad, gx[0]) and torch.equal(sa.grad, gs[0])


def test_meta_device_shapes_and_no_storage():
    x = torch.empty((2, 5, D), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    scale = torch.empty((D,), dtype=torch.float32, device="meta",
                        requires_grad=True)
    out = rmsnorm(x, scale)
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype
    gx, gs = torch.autograd.grad(out.sum(), (x, scale))
    assert gx.is_meta and gx.shape == x.shape and gx.dtype == torch.bfloat16
    assert gs.is_meta and gs.shape == (D,) and gs.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_equals_the_plain_call(dtype):
    x, scale, g = (torch.from_numpy(a).to(dtype)
                   for a in _inputs((4, 16, D), seed=2))
    grads = []
    for remat in (False, True):
        xa = x.clone().requires_grad_()
        sa = scale.clone().requires_grad_()
        out = checkpoint(rmsnorm, xa, sa, use_reentrant=False) if remat \
            else rmsnorm(xa, sa)
        (out * g).sum().backward()
        grads.append((out.detach(), xa.grad, sa.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_eps_and_gradients_without_scale_grad():
    """eps reaches the forward; a scale that needs no gradient gets none,
    and x's gradient is unchanged by that."""
    x, scale, g = (torch.from_numpy(a) for a in _inputs((3, D), seed=3))
    xa = x.clone().requires_grad_()
    (rmsnorm(xa, scale, eps=1e-2) * g).sum().backward()
    xb, sb = x.clone().requires_grad_(), scale.clone().requires_grad_()
    (rmsnorm(xb, sb, eps=1e-2) * g).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    jout = j_rmsnorm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()),
                     1e-2)
    np.testing.assert_allclose(rmsnorm(x, scale, eps=1e-2).numpy(),
                               np.asarray(jout), rtol=0,
                               atol=F32_RTOL * np.abs(np.asarray(jout)).max())
    assert rmsnorm(x, scale, eps=1e-2)[1].abs().max() < \
        rmsnorm(x, scale)[1].abs().max()
