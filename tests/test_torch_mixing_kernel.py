"""Port parity for the fused gossip batch: the plain PyTorch version matches
the JAX Pallas kernel (interpret mode) and the JAX oracle, the structural
identities hold exactly, and on a card the hand kernel matches the plain
version.

Tolerance, f32: rtol 1e-6 (plus atol 1e-6 for values near 0) — ``exp``
may differ by an ulp between XLA and PyTorch, everything else is the same
sequence of correctly rounded f32 operations.  bf16: bit for bit against
the JAX oracle, since alpha and alpha~ are rounded to bf16 before they
multiply, as JAX binds a weak Python scalar.  The hand kernel against the
plain version on the card: bit for bit at both dtypes, on every partner
map of ``chip_smoke.py``'s phase 1.
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


def _ends(w):
    p = np.arange(w, dtype=np.int32)
    p[0], p[-1] = w - 1, 0
    return p


# the partner maps of chip_smoke.py's phase 1: matchings of several sizes
# and shapes (the kernel's pair path), and one map that is not an
# involution (row 2 points at a paired row, rows 4-6 a 3-cycle), which the
# kernel takes row by row
PARTNER_MAPS = {
    "w1": np.zeros(1, np.int32),
    "w2_pair": np.array([1, 0], np.int32),
    "w15_odd": _involution(15, np.random.default_rng(15), idle=1),
    "w16_no_idle": _involution(16, np.random.default_rng(16), idle=0),
    "w16_all_idle": np.arange(16, dtype=np.int32),
    "w16_ends": _ends(16),
    "w15_ends": _ends(15),
    "w8_not_involution": np.array([1, 0, 0, 3, 5, 6, 4, 7], np.int32),
}


def _map_inputs(name, d, seed):
    partner = PARTNER_MAPS[name]
    w = len(partner)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(w, d)).astype(np.float32)
    xt = rng.normal(size=(w, d)).astype(np.float32)
    dt = rng.uniform(0.0, 1.5, size=w).astype(np.float32)
    return x, xt, partner, dt


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


@pytest.mark.parametrize("name", ["w15_odd", "w16_all_idle",
                                  "w8_not_involution", "w2_pair",
                                  "w16_ends"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_kernel_on_partner_maps(name, dtype):
    """The card's oracle on the maps the kernel's three paths take: odd W,
    all idle, a map outside the involution contract.  bf16 bit for bit;
    f32 at the file's tolerance (``exp`` may differ by an ulp)."""
    x, xt, partner, dt = _map_inputs(name, 384, seed=len(name))
    tx, txt, tp, tdt = _torch(x, xt, partner, dt)
    ox, oxt = mixing_gossip_stacked_ref(tx.to(getattr(torch, dtype)),
                                        txt.to(getattr(torch, dtype)), tp,
                                        tdt, **ACID)
    jk = j_kernel(jnp.asarray(x, getattr(jnp, dtype)),
                  jnp.asarray(xt, getattr(jnp, dtype)), jnp.asarray(partner),
                  jnp.asarray(dt), interpret=True, **ACID)
    for t, j in zip((ox, oxt), jk):
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)


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
@pytest.mark.parametrize("name", list(PARTNER_MAPS))
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16512),
                                     (torch.bfloat16, 4096),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 128)])
def test_cuda_kernel_matches_ref(name, dtype, d):
    """Bit for bit at both dtypes: the kernel runs the plain version's
    correctly rounded operations in its order, on every map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    x, xt, partner, dt = _map_inputs(name, d, seed=5)
    d_real = d - 100 if d > 128 else d
    x[:, d_real:] = 0
    xt[:, d_real:] = 0
    tx, txt, tp, tdt = _torch(x, xt, partner, dt, device="cuda")
    tx, txt = tx.to(dtype), txt.to(dtype)
    rx, rxt = mixing_gossip_stacked_ref(tx, txt, tp, tdt, **ACID)
    kxt_in = txt.clone()
    before = t_kernel.mixing_gossip_stacked.launches
    kx, kxt = t_kernel.mixing_gossip_stacked(tx, kxt_in, tp, tdt, **ACID)
    torch.cuda.synchronize()
    assert t_kernel.mixing_gossip_stacked.launches == before + 1
    assert kxt.data_ptr() == kxt_in.data_ptr()  # x~ updated in place
    assert torch.equal(kx, rx) and torch.equal(kxt, rxt)
    assert torch.all(kx[:, d_real:] == 0) and torch.all(kxt[:, d_real:] == 0)
    idle = torch.from_numpy(partner == np.arange(len(partner))).cuda()
    kx0, _ = t_kernel.mixing_gossip_stacked(tx, txt.clone(), tp, tdt,
                                            eta=0.0, alpha=0.5, alpha_t=0.5)
    assert torch.equal(kx0[idle], tx[idle])
