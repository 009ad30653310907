"""Port parity for the fused gossip batch: the plain PyTorch version matches
the JAX Pallas kernel (interpret mode) and the JAX oracle, the structural
identities hold exactly, and on a card the hand kernel matches the plain
version.

Tolerance, f32: rtol 1e-6 (plus atol 1e-6 for values near 0) — ``exp``
may differ by an ulp between XLA and PyTorch, everything else is the same
sequence of correctly rounded f32 operations.  bf16: bit for bit against
the JAX oracle, since alpha and alpha~ are rounded to bf16 before they
multiply, as JAX binds a weak Python scalar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.a2cid2_mixing.kernel import \
    mixing_gossip_stacked as j_kernel
from repro.kernels.a2cid2_mixing.ref import \
    mixing_gossip_stacked_ref as j_ref
from repro_torch.kernels.a2cid2_mixing import kernel as t_kernel
from repro_torch.kernels.a2cid2_mixing.ops import (gossip_event_stacked,
                                                   resolve_backend)
from repro_torch.kernels.a2cid2_mixing.ref import mixing_gossip_stacked_ref

ACID = dict(eta=0.11, alpha=0.5, alpha_t=1.37)


def _involution(w, rng, idle=2):
    """Random matching with at least ``idle`` self-partnered rows."""
    perm = rng.permutation(w)
    partner = np.arange(w, dtype=np.int32)
    pairs = (w - idle) // 2
    for k in range(pairs):
        i, j = perm[2 * k], perm[2 * k + 1]
        partner[i], partner[j] = j, i
    return partner


def _inputs(w, d, seed=0, d_real=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(w, d)).astype(np.float32)
    xt = rng.normal(size=(w, d)).astype(np.float32)
    if d_real is not None:  # LANE padding columns are zero
        x[:, d_real:] = 0
        xt[:, d_real:] = 0
    partner = _involution(w, rng)
    dt = rng.uniform(0.0, 1.5, size=w).astype(np.float32)
    return x, xt, partner, dt


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a.copy()).to(device) for a in arrays]


@pytest.mark.parametrize("d", [384, 16512])
@pytest.mark.parametrize("params", [ACID, dict(eta=0.0, alpha=0.5,
                                                alpha_t=0.5)])
def test_ref_matches_jax_kernel_and_oracle(d, params):
    x, xt, partner, dt = _inputs(8, d, seed=d)
    tx, txt = mixing_gossip_stacked_ref(*_torch(x, xt, partner, dt),
                                        **params)
    jx_ref, jxt_ref = j_ref(jnp.asarray(x), jnp.asarray(xt),
                            jnp.asarray(partner), jnp.asarray(dt), **params)
    # d = 16512 is past the Pallas BLOCK_D (16384): the JAX kernel pads
    jx_k, jxt_k = j_kernel(jnp.asarray(x), jnp.asarray(xt),
                           jnp.asarray(partner), jnp.asarray(dt),
                           interpret=True, **params)
    for j_out, t_out in ((jx_ref, tx), (jxt_ref, txt), (jx_k, tx),
                         (jxt_k, txt)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [384, 4096])
@pytest.mark.parametrize("params", [ACID, dict(eta=0.37, alpha=0.5,
                                                alpha_t=1.37)])
def test_ref_bf16_matches_jax_bitwise(d, params):
    x, xt, partner, dt = _inputs(8, d, seed=d + 1)
    tx, txt, tp, tdt = _torch(x, xt, partner, dt)
    ox, oxt = mixing_gossip_stacked_ref(tx.bfloat16(), txt.bfloat16(), tp,
                                        tdt, **params)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(xt, jnp.bfloat16),
             jnp.asarray(partner), jnp.asarray(dt))
    for j_out in (j_ref(*jargs, **params),
                  j_kernel(*jargs, interpret=True, **params)):
        for t, j in zip((ox, oxt), j_out):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))


def test_ref_identities_exact():
    x, xt, partner, dt = _inputs(8, 384, seed=1, d_real=300)
    tx, txt, tp, tdt = _torch(x, xt, partner, dt)
    idle = torch.from_numpy(partner == np.arange(8))
    assert idle.any()
    # eta = 0: an idle row is untouched, bit for bit
    ox, oxt = mixing_gossip_stacked_ref(tx, txt, tp, tdt, eta=0.0,
                                        alpha=0.5, alpha_t=0.5)
    assert torch.equal(ox[idle], tx[idle]) and torch.equal(oxt[idle],
                                                           txt[idle])
    # eta > 0: an idle row is a pure mixing step (x + x~ conserved exactly
    # up to the one rounding of each output)
    ox, oxt = mixing_gossip_stacked_ref(tx, txt, tp, tdt, **ACID)
    c = (0.5 * (1.0 - torch.exp(-2.0 * ACID["eta"] * tdt)))[:, None]
    dd = txt - tx
    assert torch.equal(ox[idle], (tx + c * dd)[idle])
    assert torch.equal(oxt[idle], (txt - c * dd)[idle])
    # padding columns stay 0
    assert torch.all(ox[:, 300:] == 0) and torch.all(oxt[:, 300:] == 0)
    # the inputs are left as they were (the plain version is pure)
    assert torch.equal(tx, torch.from_numpy(x))
    assert torch.equal(txt, torch.from_numpy(xt))


def test_dispatch_follows_the_tensor():
    x = torch.zeros(2, 128)
    assert resolve_backend("auto", x) == "ref"
    with pytest.raises(ValueError):
        resolve_backend("cuda", x)
    with pytest.raises(ValueError):
        resolve_backend("pallas", x)
    # the kernel wrapper never runs a CPU tensor, and launches nothing
    before = t_kernel.mixing_gossip_stacked.launches
    with pytest.raises(ValueError):
        t_kernel.mixing_gossip_stacked(
            x, x.clone(), torch.arange(2, dtype=torch.int32),
            torch.zeros(2), eta=0.0, alpha=0.5, alpha_t=0.5)
    assert t_kernel.mixing_gossip_stacked.launches == before
    ox, oxt = gossip_event_stacked(x, x.clone(),
                                   torch.arange(2, dtype=torch.int32),
                                   torch.zeros(2), eta=0.0, alpha=0.5,
                                   alpha_t=0.5)
    assert torch.equal(ox, x) and torch.equal(oxt, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,tol", [(torch.float32, 16512, 1e-6),
                                         (torch.bfloat16, 4096, 0.0)])
def test_cuda_kernel_matches_ref(dtype, d, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    x, xt, partner, dt = _inputs(8, d, seed=5, d_real=d - 100)
    tx, txt, tp, tdt = _torch(x, xt, partner, dt, device="cuda")
    tx, txt = tx.to(dtype), txt.to(dtype)
    rx, rxt = mixing_gossip_stacked_ref(tx, txt, tp, tdt, **ACID)
    kxt_in = txt.clone()
    before = t_kernel.mixing_gossip_stacked.launches
    kx, kxt = t_kernel.mixing_gossip_stacked(tx, kxt_in, tp, tdt, **ACID)
    torch.cuda.synchronize()
    assert t_kernel.mixing_gossip_stacked.launches == before + 1
    assert kxt.data_ptr() == kxt_in.data_ptr()  # x~ updated in place
    torch.testing.assert_close(kx.float(), rx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(kxt.float(), rxt.float(), rtol=tol, atol=tol)
    assert torch.all(kx[:, d - 100:] == 0) and torch.all(kxt[:, d - 100:] == 0)
    idle = torch.from_numpy(partner == np.arange(8)).cuda()
    kx0, _ = t_kernel.mixing_gossip_stacked(tx, txt.clone(), tp, tdt,
                                            eta=0.0, alpha=0.5, alpha_t=0.5)
    assert torch.equal(kx0[idle], tx[idle])
