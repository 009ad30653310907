"""Port parity for the world-batched gossip kernels.

  * the plain versions ``mixing_gossip_worlds_ref`` and
    ``channel_gossip_worlds_ref`` match the JAX oracles and the JAX Pallas
    kernels (interpret mode) on batches that mix baseline (eta 0) and
    A2CiD2 worlds: at f32 within rtol 1e-6 / atol 1e-6 (``exp`` may differ
    by an ulp between XLA and PyTorch), at bf16 bit for bit against the
    JAX oracle;
  * per world, they equal the port's stacked plain versions bit for bit;
  * the backend follows the tensor: CPU tensors take the plain version;
  * on a card (``-m gpu``), the CUDA kernels against the plain versions
    (within 1e-5 at f32, exactly at bf16), per world bit for bit the
    stacked CUDA kernels, the exact identities, and the refusal of an
    unsupported dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.a2cid2_mixing.kernel import \
    channel_gossip_worlds as j_channel_kernel
from repro.kernels.a2cid2_mixing.kernel import \
    mixing_gossip_worlds as j_mixing_kernel
from repro.kernels.a2cid2_mixing.ref import \
    channel_gossip_worlds_ref as j_channel_ref
from repro.kernels.a2cid2_mixing.ref import \
    mixing_gossip_worlds_ref as j_mixing_ref
from repro_torch.kernels.a2cid2_mixing import kernel as t_kernel
from repro_torch.kernels.a2cid2_mixing.ops import (channel_event_worlds,
                                                   gossip_event_worlds)
from repro_torch.kernels.a2cid2_mixing.ref import (
    channel_gossip_stacked_ref, channel_gossip_worlds_ref,
    mixing_gossip_stacked_ref, mixing_gossip_worlds_ref)

TOL_F32 = dict(rtol=1e-6, atol=1e-6)
# world 0 and 2 run the baseline, worlds 1 and 3 A2CiD2 (two settings)
ETA = np.array([0.0, 0.37, 0.0, 0.11], np.float32)
ALPHA = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
ALPHA_T = np.array([0.5, 1.37, 0.5, 2.9], np.float32)


def _involution(w, rng, idle):
    perm = rng.permutation(w)
    partner = np.arange(w, dtype=np.int32)
    for k in range((w - idle) // 2):
        i, j = perm[2 * k], perm[2 * k + 1]
        partner[i], partner[j] = j, i
    return partner


def _inputs(b, w, d, seed, d_real=None):
    """(B, W, D) buffers, per-world involutions with idle rows, dt, and
    channel rows mixing honest, 1e3-scale, sign-flip, rejected (mscale 0)
    and norm-clipped reads."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, w, d)).astype(np.float32)
    xt = rng.normal(size=(b, w, d)).astype(np.float32)
    if d_real is not None:
        x[:, :, d_real:] = 0
        xt[:, :, d_real:] = 0
    partner = np.stack([_involution(w, rng, idle=2 + i % 2)
                        for i in range(b)])
    dt = rng.uniform(0.0, 1.5, size=(b, w)).astype(np.float32)
    xp = np.take_along_axis(x, partner[:, :, None].astype(np.int64), axis=1)
    corrupt = np.zeros((b, w), np.float32)
    mscale = np.ones((b, w), np.float32)
    corrupt[:, 0], corrupt[:, 1] = 999.0, -2.0
    mscale[:, 2], mscale[:, 3] = 0.0, 0.3
    return dict(x=x, xt=xt, partner=partner, dt=dt, xp=xp, corrupt=corrupt,
                mscale=mscale, eta=ETA[:b], alpha=ALPHA[:b],
                alpha_t=ALPHA_T[:b])


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _mixing_args(inp, mod, dtype):
    cast = _t if mod == "t" else _j
    return (cast(inp["x"], dtype), cast(inp["xt"], dtype),
            cast(inp["partner"]), cast(inp["dt"]), cast(inp["eta"]),
            cast(inp["alpha"]), cast(inp["alpha_t"]))


def _channel_args(inp, mod, dtype):
    cast = _t if mod == "t" else _j
    return (cast(inp["x"], dtype), cast(inp["xt"], dtype),
            cast(inp["xp"], dtype), cast(inp["corrupt"]),
            cast(inp["mscale"]), cast(inp["dt"]), cast(inp["eta"]),
            cast(inp["alpha"]), cast(inp["alpha_t"]))


def _compare(t_outs, j_outs, exact):
    assert len(t_outs) == len(j_outs)
    for t, j in zip(t_outs, j_outs):
        tv, jv = t.float().numpy(), np.asarray(j, np.float32)
        if exact:
            np.testing.assert_array_equal(tv, jv)
        else:
            np.testing.assert_allclose(tv, jv, **TOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 16512])
def test_mixing_worlds_ref_matches_jax(dtype, d):
    inp = _inputs(4, 8, d, seed=d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tout = mixing_gossip_worlds_ref(*_mixing_args(inp, "t", tdt))
    jargs = _mixing_args(inp, "j", jdt)
    _compare(tout, j_mixing_ref(*jargs), exact=dtype == "bfloat16")
    # d = 16512 is past the Pallas BLOCK_D (16384): the JAX kernel pads
    _compare(tout, j_mixing_kernel(*jargs, interpret=True), exact=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 2.5])
@pytest.mark.parametrize("want_rej", [False, True])
def test_channel_worlds_ref_matches_jax(dtype, clip, want_rej):
    inp = _inputs(4, 8, 384, seed=11)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    kw = dict(clip=clip, want_rej=want_rej)
    tout = channel_gossip_worlds_ref(*_channel_args(inp, "t", tdt), **kw)
    jargs = _channel_args(inp, "j", jdt)
    _compare(tout, j_channel_ref(*jargs, **kw), exact=dtype == "bfloat16")
    _compare(tout, j_channel_kernel(*jargs, interpret=True, **kw),
             exact=False)
    if want_rej:   # the mask is exact
        np.testing.assert_array_equal(tout[2].numpy(),
                                      (inp["mscale"] == 0).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_worlds_ref_is_stacked_ref_per_world(dtype):
    """Row b of a worlds batch is the stacked plain version with world b's
    scalars, bit for bit (baseline and A2CiD2 worlds in one batch)."""
    inp = _inputs(4, 8, 256, seed=3, d_real=200)
    mx, mxt = mixing_gossip_worlds_ref(*_mixing_args(inp, "t", dtype))
    cx, cxt, rej = channel_gossip_worlds_ref(
        *_channel_args(inp, "t", dtype), clip=2.5, want_rej=True)
    for b in range(4):
        dyn = dict(eta=float(inp["eta"][b]), alpha=float(inp["alpha"][b]),
                   alpha_t=float(inp["alpha_t"][b]))
        sx, sxt = mixing_gossip_stacked_ref(
            _t(inp["x"][b], dtype), _t(inp["xt"][b], dtype),
            _t(inp["partner"][b]), _t(inp["dt"][b]), **dyn)
        assert torch.equal(mx[b], sx) and torch.equal(mxt[b], sxt)
        kx, kxt, krej = channel_gossip_stacked_ref(
            _t(inp["x"][b], dtype), _t(inp["xt"][b], dtype),
            _t(inp["xp"][b], dtype), _t(inp["corrupt"][b]),
            _t(inp["mscale"][b]), _t(inp["dt"][b]), clip=2.5,
            want_rej=True, **dyn)
        assert torch.equal(cx[b], kx) and torch.equal(cxt[b], kxt)
        assert torch.equal(rej[b], krej)
    # padding columns stay 0 and the inputs are left as they were
    assert (mx[:, :, 200:] == 0).all() and (cxt[:, :, 200:] == 0).all()
    assert torch.equal(_t(inp["x"], dtype), _mixing_args(inp, "t",
                                                         dtype)[0])


def test_worlds_dispatch_follows_the_tensor():
    inp = _inputs(2, 4, 128, seed=4)
    args = _mixing_args(inp, "t", torch.float32)
    before = t_kernel.mixing_gossip_worlds.launches
    out = gossip_event_worlds(*args)          # CPU tensors: plain version
    ref = mixing_gossip_worlds_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    cargs = _channel_args(inp, "t", torch.float32)
    cout = channel_event_worlds(*cargs, want_rej=True)
    cref = channel_gossip_worlds_ref(*cargs, want_rej=True)
    assert all(torch.equal(a, b) for a, b in zip(cout, cref))
    # the kernel wrappers never run a CPU tensor, and launch nothing
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_kernel.mixing_gossip_worlds(*args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_kernel.channel_gossip_worlds(*cargs)
    assert t_kernel.mixing_gossip_worlds.launches == before


# ------------------------------------------------------------ on a card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,tol", [(torch.float32, 16512, 1e-5),
                                         (torch.bfloat16, 4096, 0.0)])
def test_cuda_worlds_kernels_match_ref_and_stacked(dtype, d, tol):
    _cuda_or_skip()
    inp = _inputs(4, 16, d, seed=5, d_real=d - 100)
    args = [a.cuda() for a in _mixing_args(inp, "t", dtype)]
    rx, rxt = mixing_gossip_worlds_ref(*args)
    kxt_in = args[1].clone()
    before = t_kernel.mixing_gossip_worlds.launches
    kx, kxt = gossip_event_worlds(args[0], kxt_in, *args[2:])
    torch.cuda.synchronize()
    assert t_kernel.mixing_gossip_worlds.launches == before + 1
    assert kxt.data_ptr() == kxt_in.data_ptr()   # x~ updated in place
    torch.testing.assert_close(kx.float(), rx.float(), rtol=0, atol=tol)
    torch.testing.assert_close(kxt.float(), rxt.float(), rtol=0, atol=tol)
    cargs = [a.cuda() for a in _channel_args(inp, "t", dtype)]
    crx, crxt, crej = channel_gossip_worlds_ref(*cargs, clip=2.5,
                                                want_rej=True)
    ckx, ckxt, ckrej = t_kernel.channel_gossip_worlds(
        cargs[0], cargs[1].clone(), *cargs[2:], clip=2.5, want_rej=True)
    torch.testing.assert_close(ckx.float(), crx.float(), rtol=0, atol=tol)
    torch.testing.assert_close(ckxt.float(), crxt.float(), rtol=0, atol=tol)
    assert torch.equal(ckrej, crej)
    assert (kx[:, :, d - 100:] == 0).all() and (ckxt[:, :, d - 100:] == 0
                                                ).all()
    for b in range(4):   # per world, bit for bit the stacked kernels
        dyn = dict(eta=float(inp["eta"][b]), alpha=float(inp["alpha"][b]),
                   alpha_t=float(inp["alpha_t"][b]))
        sx, sxt = t_kernel.mixing_gossip_stacked(
            args[0][b].contiguous(), args[1][b].clone(),
            args[2][b].contiguous(), args[3][b].contiguous(), **dyn)
        assert torch.equal(kx[b], sx) and torch.equal(kxt[b], sxt)
        cx, cxt = t_kernel.channel_gossip_stacked(
            cargs[0][b].contiguous(), cargs[1][b].clone(),
            cargs[2][b].contiguous(), cargs[3][b].contiguous(),
            cargs[4][b].contiguous(), cargs[5][b].contiguous(), clip=2.5,
            **dyn)
        assert torch.equal(ckx[b], cx) and torch.equal(ckxt[b], cxt)


@pytest.mark.gpu
def test_cuda_worlds_identities_and_refusals():
    _cuda_or_skip()
    inp = _inputs(4, 16, 16512, seed=6)
    args = [a.cuda() for a in _mixing_args(inp, "t", torch.float32)]
    x, xt, partner, dt = args[:4]
    # the channel kernel at corrupt 0, mscale 1, no clip is the clean one
    kx, kxt = t_kernel.mixing_gossip_worlds(x, xt.clone(), *args[2:])
    b_idx = torch.arange(4, device="cuda")[:, None]
    cx, cxt = t_kernel.channel_gossip_worlds(
        x, xt.clone(), x[b_idx, partner.long()].contiguous(),
        torch.zeros_like(dt), torch.ones_like(dt), dt, *args[4:])
    assert torch.equal(kx, cx) and torch.equal(kxt, cxt)
    # an idle row of a baseline (eta 0) world is untouched
    idle = partner == torch.arange(16, device="cuda")
    base = (args[4] == 0)[:, None] & idle
    assert base.any()
    assert torch.equal(kx[base], x[base]) and torch.equal(kxt[base],
                                                          xt[base])
    # an unsupported dtype raises instead of falling back
    with pytest.raises(TypeError, match="not supported"):
        t_kernel.mixing_gossip_worlds(x.half(), xt.half(), *args[2:])
    with pytest.raises(ValueError, match="partner"):
        t_kernel.mixing_gossip_worlds(x, xt.clone(), partner.long(),
                                      *args[3:])
