"""Hopper kernels for the fused A2CiD2 gossip batches, built and bound by hand.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with one plain C entry point, ``<name>_launch``, at first
use, and loaded with ``ctypes`` (``kernels/build.py``, shared by every
kernel of the port).  Nothing is built or loaded when this module is
imported, so the CPU tests import it freely.

The kernels replace the JAX package's Pallas TPU kernels of the same names
in ``repro/kernels/a2cid2_mixing/kernel.py``; each source file states what
it computes, what bounds it and how it is laid out.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import DTYPE_CODE, entry
from .ref import dtype_scalar

LANE = 128
_P, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)
_ARGTYPES = {
    # dtype, x, x_tilde, out_x, partner, dt_next, w, d, neg2eta, alpha,
    # alpha_t, stream
    "mixing_gossip_stacked": (_I, _P, _P, _P, _P, _P, _LL, _LL, _F, _F, _F,
                              _P),
    # dtype, x, xp, x_tilde, out_x, corrupt, mscale, dt_next, rej, w, d,
    # neg2eta, alpha, alpha_t, has_clip, clip, stream
    "channel_gossip_stacked": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                               _F, _F, _F, _I, _F, _P),
    # dtype, x, x_tilde, out_x, partner, dt_next, eta, alpha, alpha_t, b, w,
    # d, stream
    "mixing_gossip_worlds": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                             _LL, _P),
    # dtype, x, xp, x_tilde, out_x, corrupt, mscale, dt_next, eta, alpha,
    # alpha_t, rej, b, w, d, has_clip, clip, stream
    "channel_gossip_worlds": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _LL, _LL, _LL, _I, _F, _P),
    # dtype, x, x_tilde, xp, out_x, dt_next, d, neg2eta, alpha, alpha_t,
    # stream
    "p2p_mixing": (_I, _P, _P, _P, _P, _P, _LL, _F, _F, _F, _P),
    # dtype, x, x_tilde, xp, out_x, out_xt, dt, n, neg2eta, alpha, alpha_t,
    # stream
    "mixing_p2p": (_I, _P, _P, _P, _P, _P, _P, _LL, _F, _F, _F, _P),
}


def _entry(name: str):
    return entry(name, _ARGTYPES[name])


def _check_rows(name: str, x: torch.Tensor, rows: dict,
                vectors: dict) -> None:
    """The checks every wrapper shares: ``x`` and the ``rows`` buffers are
    contiguous, 16-byte aligned, of one supported dtype and shape on one
    card, (W, D) for a stacked kernel or (B, W, D) for a worlds kernel, whose
    W or B * W rows must fit the grid's y dimension; ``vectors`` maps a name
    to its tensor, required dtype and kind: "row" for one value per row
    ((W,) or (B, W)), "world" for one value per world ((B,))."""
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only; CPU tensors "
                         f"take the plain version (ops.py)")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"buffer dtype {x.dtype} is not supported by the "
                        f"CUDA kernel (float32, bfloat16)")
    worlds = name.endswith("_worlds")
    if x.dim() != (3 if worlds else 2):
        raise ValueError(f"x must be {'(B, W, D)' if worlds else '(W, D)'}, "
                         f"got {tuple(x.shape)}")
    rows_n, d = x.shape[:-1].numel(), x.shape[-1]
    if not 1 <= rows_n <= 65535 or d % LANE:
        raise ValueError(f"need 1 <= {'B * W' if worlds else 'W'} <= 65535 "
                         f"rows and D % {LANE} == 0, got {tuple(x.shape)}")
    for key, t in {"x": x, **rows}.items():
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{key} is {t.dtype}, x is {x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{key} must share x's shape, got "
                             f"{tuple(t.shape)} and {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{key} must be 16-byte aligned")
    for key, (t, dtype, kind) in vectors.items():
        shape = x.shape[:-1] if kind == "row" else x.shape[:1]
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, x on {x.device}")
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{key} must be a contiguous {tuple(shape)} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def mixing_gossip_stacked(x: torch.Tensor, x_tilde: torch.Tensor,
                          partner: torch.Tensor, dt_next: torch.Tensor, *,
                          eta: float, alpha: float, alpha_t: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One coalesced gossip batch on the card: p2p then mix.

    x, x_tilde: (W, D) float32 or bfloat16, contiguous, D % 128 == 0;
    partner: (W,) int32 involution on the same device (partner[w] == w for
    idle workers; its values are trusted, not checked, since checking them
    would synchronise with the card); dt_next: (W,) float32.  alpha and
    alpha_t are rounded here to the buffer dtype, as JAX binds a weak
    scalar.

    ``x_tilde`` is updated IN PLACE, as the Pallas kernel aliases it to its
    output; the returned pair is ``(out_x, x_tilde)`` with ``out_x`` fresh.
    The launch is queued on the current stream and not waited for.  Each
    launch adds one to ``mixing_gossip_stacked.launches``.
    """
    _check_rows("mixing_gossip_stacked", x, {"x_tilde": x_tilde},
                {"partner": (partner, torch.int32, "row"),
                 "dt_next": (dt_next, torch.float32, "row")})
    w, d = x.shape
    out_x = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry("mixing_gossip_stacked")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(),
            out_x.data_ptr(), partner.data_ptr(), dt_next.data_ptr(), w, d,
            float(-2.0 * eta), dtype_scalar(alpha, x.dtype),
            dtype_scalar(alpha_t, x.dtype), _stream(x))
    if err != 0:
        raise RuntimeError(f"mixing_gossip_stacked launch failed: CUDA "
                           f"error {err}")
    mixing_gossip_stacked.launches += 1
    return out_x, x_tilde


mixing_gossip_stacked.launches = 0


def channel_gossip_stacked(x: torch.Tensor, x_tilde: torch.Tensor,
                           x_partner: torch.Tensor, corrupt: torch.Tensor,
                           mscale: torch.Tensor, dt_next: torch.Tensor, *,
                           eta: float, alpha: float, alpha_t: float,
                           clip: float | None = None,
                           want_rej: bool = False):
    """One unreliable-channel gossip batch on the card: p2p then mix.

    x, x_tilde, x_partner: (W, D) float32 or bfloat16, contiguous, D % 128
    == 0, the partner values pre-gathered (fresh rows or ring snapshots);
    corrupt, mscale, dt_next: (W,) float32.  ``clip`` is the coordinate
    clip (None: none); it, alpha and alpha_t are rounded here to the buffer
    dtype as JAX binds a weak scalar.  ``want_rej`` adds the (W,) float32
    rejection mask ``mscale == 0`` as a third output.

    ``x_tilde`` is updated IN PLACE, as the Pallas kernel aliases it;
    ``out_x`` (and the mask) are fresh.  The launch is queued on the current
    stream and not waited for.  Each launch adds one to
    ``channel_gossip_stacked.launches``.
    """
    _check_rows("channel_gossip_stacked", x,
                {"x_tilde": x_tilde, "x_partner": x_partner},
                {"corrupt": (corrupt, torch.float32, "row"),
                 "mscale": (mscale, torch.float32, "row"),
                 "dt_next": (dt_next, torch.float32, "row")})
    w, d = x.shape
    out_x = torch.empty_like(x)
    rej = torch.empty(w, dtype=torch.float32, device=x.device) \
        if want_rej else None
    with torch.cuda.device(x.device):
        err = _entry("channel_gossip_stacked")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_partner.data_ptr(),
            x_tilde.data_ptr(), out_x.data_ptr(), corrupt.data_ptr(),
            mscale.data_ptr(), dt_next.data_ptr(),
            None if rej is None else rej.data_ptr(), w, d,
            float(-2.0 * eta), dtype_scalar(alpha, x.dtype),
            dtype_scalar(alpha_t, x.dtype),
            int(clip is not None),
            0.0 if clip is None else dtype_scalar(clip, x.dtype),
            _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_gossip_stacked launch failed: CUDA "
                           f"error {err}")
    channel_gossip_stacked.launches += 1
    if want_rej:
        return out_x, x_tilde, rej
    return out_x, x_tilde


channel_gossip_stacked.launches = 0


def mixing_gossip_worlds(x: torch.Tensor, x_tilde: torch.Tensor,
                         partner: torch.Tensor, dt_next: torch.Tensor,
                         eta: torch.Tensor, alpha: torch.Tensor,
                         alpha_t: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One coalesced gossip batch over B worlds on the card: p2p then mix.

    x, x_tilde: (B, W, D) float32 or bfloat16, contiguous, D % 128 == 0,
    B * W <= 65535; partner: (B, W) int32, each row an involution of
    [0, W) (trusted, not checked); dt_next: (B, W) float32; eta, alpha,
    alpha_t: (B,) float32 per-world dynamics on the same card, read by the
    kernel (never copied to the host).  Per world the result is bit for bit
    ``mixing_gossip_stacked`` with that world's scalars.

    ``x_tilde`` is updated IN PLACE; the returned pair is ``(out_x,
    x_tilde)`` with ``out_x`` fresh.  The launch is queued on the current
    stream and not waited for.  Each launch adds one to
    ``mixing_gossip_worlds.launches``.
    """
    _check_rows("mixing_gossip_worlds", x, {"x_tilde": x_tilde},
                {"partner": (partner, torch.int32, "row"),
                 "dt_next": (dt_next, torch.float32, "row"),
                 "eta": (eta, torch.float32, "world"),
                 "alpha": (alpha, torch.float32, "world"),
                 "alpha_t": (alpha_t, torch.float32, "world")})
    b, w, d = x.shape
    out_x = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry("mixing_gossip_worlds")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(),
            out_x.data_ptr(), partner.data_ptr(), dt_next.data_ptr(),
            eta.data_ptr(), alpha.data_ptr(), alpha_t.data_ptr(), b, w, d,
            _stream(x))
    if err != 0:
        raise RuntimeError(f"mixing_gossip_worlds launch failed: CUDA "
                           f"error {err}")
    mixing_gossip_worlds.launches += 1
    return out_x, x_tilde


mixing_gossip_worlds.launches = 0


def channel_gossip_worlds(x: torch.Tensor, x_tilde: torch.Tensor,
                          x_partner: torch.Tensor, corrupt: torch.Tensor,
                          mscale: torch.Tensor, dt_next: torch.Tensor,
                          eta: torch.Tensor, alpha: torch.Tensor,
                          alpha_t: torch.Tensor, *,
                          clip: float | None = None,
                          want_rej: bool = False):
    """One unreliable-channel gossip batch over B worlds on the card.

    x, x_tilde, x_partner: (B, W, D) float32 or bfloat16, contiguous,
    D % 128 == 0, B * W <= 65535, the partner values pre-gathered per world;
    corrupt, mscale, dt_next: (B, W) float32; eta, alpha, alpha_t: (B,)
    float32 on the same card.  ``clip`` is the coordinate clip shared by
    every world (None: none), rounded here to the buffer dtype.
    ``want_rej`` adds the (B, W) float32 rejection mask ``mscale == 0`` as
    a third output.  Per world the result is bit for bit
    ``channel_gossip_stacked`` with that world's scalars.

    ``x_tilde`` is updated IN PLACE; ``out_x`` (and the mask) are fresh.
    The launch is queued on the current stream and not waited for.  Each
    launch adds one to ``channel_gossip_worlds.launches``.
    """
    _check_rows("channel_gossip_worlds", x,
                {"x_tilde": x_tilde, "x_partner": x_partner},
                {"corrupt": (corrupt, torch.float32, "row"),
                 "mscale": (mscale, torch.float32, "row"),
                 "dt_next": (dt_next, torch.float32, "row"),
                 "eta": (eta, torch.float32, "world"),
                 "alpha": (alpha, torch.float32, "world"),
                 "alpha_t": (alpha_t, torch.float32, "world")})
    b, w, d = x.shape
    out_x = torch.empty_like(x)
    rej = torch.empty((b, w), dtype=torch.float32, device=x.device) \
        if want_rej else None
    with torch.cuda.device(x.device):
        err = _entry("channel_gossip_worlds")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_partner.data_ptr(),
            x_tilde.data_ptr(), out_x.data_ptr(), corrupt.data_ptr(),
            mscale.data_ptr(), dt_next.data_ptr(), eta.data_ptr(),
            alpha.data_ptr(), alpha_t.data_ptr(),
            None if rej is None else rej.data_ptr(), b, w, d,
            int(clip is not None),
            0.0 if clip is None else dtype_scalar(clip, x.dtype),
            _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_gossip_worlds launch failed: CUDA "
                           f"error {err}")
    channel_gossip_worlds.launches += 1
    if want_rej:
        return out_x, x_tilde, rej
    return out_x, x_tilde


channel_gossip_worlds.launches = 0


def _check_flat(name: str, x: torch.Tensor, others: dict,
                dt: torch.Tensor) -> None:
    """The checks of the two flat-vector kernels: ``x`` and ``others`` are
    contiguous tensors of one supported dtype and shape on one card, and
    ``dt`` is one float32 on the same card."""
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only; CPU tensors "
                         f"take the plain version (ops.py)")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"buffer dtype {x.dtype} is not supported by the "
                        f"CUDA kernel (float32, bfloat16)")
    for key, t in {"x": x, **others}.items():
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{key} is {t.dtype}, x is {x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{key} must share x's shape, got "
                             f"{tuple(t.shape)} and {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    if (dt.device != x.device or dt.dtype != torch.float32
            or dt.numel() != 1):
        raise ValueError(f"dt must be one float32 on {x.device}, got "
                         f"{tuple(dt.shape)} {dt.dtype} on {dt.device}")


def p2p_mixing(x: torch.Tensor, x_tilde: torch.Tensor,
               x_partner: torch.Tensor, dt_next: torch.Tensor, *,
               eta: float, alpha: float, alpha_t: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip event on one worker's flat vectors on the card: p2p
    against ``x_partner``, then mix for ``dt_next``.

    x, x_tilde, x_partner: (D,) float32 or bfloat16, contiguous, 16-byte
    aligned, D % 128 == 0 (a packed ``FlatLayout`` vector, or a row of
    one); dt_next: one float32 on the same card (0-dim or (1,), e.g. a view
    into the event-gap tensor), read by the kernel, never by the host.
    alpha and alpha_t are rounded here to the buffer dtype, as JAX binds a
    weak scalar.

    ``x_tilde`` is updated IN PLACE, as in the stacked kernel; the returned
    pair is ``(out_x, x_tilde)`` with ``out_x`` fresh.  The launch is queued
    on the current stream and not waited for.  Each launch adds one to
    ``p2p_mixing.launches``.
    """
    _check_flat("p2p_mixing", x, {"x_tilde": x_tilde,
                                  "x_partner": x_partner}, dt_next)
    if x.dim() != 1 or x.shape[0] % LANE or x.shape[0] == 0:
        raise ValueError(f"x must be (D,) with D a positive multiple of "
                         f"{LANE}, got {tuple(x.shape)}")
    for key, t in (("x", x), ("x_tilde", x_tilde), ("x_partner", x_partner)):
        if t.data_ptr() % 16:
            raise ValueError(f"{key} must be 16-byte aligned")
    out_x = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry("p2p_mixing")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(),
            x_partner.data_ptr(), out_x.data_ptr(), dt_next.data_ptr(),
            x.shape[0], float(-2.0 * eta), dtype_scalar(alpha, x.dtype),
            dtype_scalar(alpha_t, x.dtype), _stream(x))
    if err != 0:
        raise RuntimeError(f"p2p_mixing launch failed: CUDA error {err}")
    p2p_mixing.launches += 1
    return out_x, x_tilde


p2p_mixing.launches = 0


def mixing_p2p(x: torch.Tensor, x_tilde: torch.Tensor,
               x_partner: torch.Tensor, dt: torch.Tensor, *, eta: float,
               alpha: float, alpha_t: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip event on one tensor of any shape and length on the card:
    mix for ``dt``, then p2p against ``x_partner`` (the partner's already
    mixed x).

    x, x_tilde, x_partner: one shape, float32 or bfloat16, contiguous, at
    any element alignment; dt: one float32 on the same card, read by the
    kernel.  alpha and alpha_t are rounded here to the buffer dtype.
    Returns two fresh tensors of x's shape; the inputs are left as they
    were.  The launch is queued on the current stream and not waited for.
    Each launch adds one to ``mixing_p2p.launches``; an empty tensor
    launches nothing.
    """
    _check_flat("mixing_p2p", x, {"x_tilde": x_tilde,
                                  "x_partner": x_partner}, dt)
    out_x, out_xt = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return out_x, out_xt
    with torch.cuda.device(x.device):
        err = _entry("mixing_p2p")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(),
            x_partner.data_ptr(), out_x.data_ptr(), out_xt.data_ptr(),
            dt.data_ptr(), x.numel(), float(-2.0 * eta),
            dtype_scalar(alpha, x.dtype), dtype_scalar(alpha_t, x.dtype),
            _stream(x))
    if err != 0:
        raise RuntimeError(f"mixing_p2p launch failed: CUDA error {err}")
    mixing_p2p.launches += 1
    return out_x, out_xt


mixing_p2p.launches = 0
