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
import functools

import numpy as np
import torch

from ...analysis.op_cost import record
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
    # dtype, segments, count, blocks, chunk, dt, neg2eta, alpha, alpha_t,
    # stream
    "mixing_p2p": (_I, _P, _I, _LL, _LL, _P, _F, _F, _F, _P),
    # dtype, x, x_tilde, w, d, segments, launches, counts, kinds, blocks,
    # gscale, coeff, gamma, factor, inv_w, partials, row, stream
    "tick_tail_stacked": (_I, _P, _P, _LL, _LL, _P, _I, _P, _P, _P, _P, _P,
                          _F, _F, _F, _P, _P, _P),
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
    partner: (W,) int32 on the same device, an involution by contract
    (partner[w] == w for idle workers; the kernel reads a pair's rows once
    for both, and takes any other map row by row, re-reading the partner's
    row; its values are trusted, not checked, since checking them would
    synchronise with the card); dt_next: (W,) float32.  alpha and
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
    # x, x~ read once, out_x and x~ written once; partner, dt_next read
    record("mixing_gossip_stacked", 0.0,
           4 * x.numel() * x.element_size() + 2 * w * 4)
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
    # x, xp, x~ read once, out_x and x~ written once; corrupt, mscale,
    # dt_next read, the mask written
    record("channel_gossip_stacked", 0.0,
           5 * x.numel() * x.element_size() + (3 + want_rej) * w * 4)
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
    # x, x~ read once, out_x and x~ written once; partner, dt_next and the
    # three (B,) scalars read
    record("mixing_gossip_worlds", 0.0,
           4 * x.numel() * x.element_size() + 2 * b * w * 4 + 3 * b * 4)
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
    # x, xp, x~ read once, out_x and x~ written once; corrupt, mscale,
    # dt_next and the three (B,) scalars read, the mask written
    record("channel_gossip_worlds", 0.0,
           5 * x.numel() * x.element_size() + (3 + want_rej) * b * w * 4
           + 3 * b * 4)
    if want_rej:
        return out_x, x_tilde, rej
    return out_x, x_tilde


channel_gossip_worlds.launches = 0


def _check_flat(name: str, x: torch.Tensor, others: dict,
                dt: torch.Tensor) -> None:
    """The checks of the flat-vector kernel: ``x`` and ``others`` are
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
    # x, x~, xp read once, out_x and x~ written once; dt_next read
    record("p2p_mixing", 0.0, 5 * x.numel() * x.element_size() + 4)
    return out_x, x_tilde


p2p_mixing.launches = 0


# One row of mixing_p2p's launch table, laid out as csrc/mixing_p2p.cu's
# Segment: a leaf's five pointers and length, the 16-byte vectors of its
# body and the scalar elements before it, and its first block.
SEGMENT = np.dtype([("x", "<u8"), ("x_tilde", "<u8"), ("xp", "<u8"),
                    ("out_x", "<u8"), ("out_xt", "<u8"), ("n", "<i8"),
                    ("body", "<i8"), ("head", "<i4"),
                    ("first_block", "<i4")])
MAX_SEGMENTS = 63  # leaves a launch: kMaxSegments in mixing_p2p.cu
CHUNK = 4096       # elements a block: kChunk in mixing_p2p.cu
# each output leaf starts at its x's offset modulo this many bytes (a
# cache line), so that the five pointers of a leaf line up within 16 bytes
# whenever x, x~ and xp do
OUT_ALIGN = 128
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# alpha and alpha~ at a dtype, once per value rather than once per launch
_dtype_scalar = functools.lru_cache(maxsize=64)(dtype_scalar)


def out_offsets(x_ptrs, sizes, itemsize: int) -> tuple[list, int]:
    """Element offsets of the leaves' outputs in one buffer that starts on
    an ``OUT_ALIGN``-byte boundary: each after the one before, at the byte
    offset of its x modulo ``OUT_ALIGN``.  Returns (offsets, the buffer's
    length in elements)."""
    offsets, end = [], 0
    for ptr, n in zip(x_ptrs, sizes):
        pos = end * itemsize
        o = (pos + (ptr - pos) % OUT_ALIGN) // itemsize
        offsets.append(o)
        end = o + n
    return offsets, end


def plan_launches(rows, itemsize: int, *, max_segments: int = MAX_SEGMENTS,
                  chunk: int = CHUNK) -> list:
    """The launches of ``mixing_p2p`` for the leaves of one dtype.

    ``rows`` holds (x, x_tilde, xp, out_x, out_xt, n) of each leaf with n
    >= 1: five addresses and a length.  A leaf whose five addresses share
    their offset within 16 bytes splits into a scalar head up to the next
    16-byte boundary, a body of 16-byte vectors and a scalar tail; any
    other leaf is scalar throughout.  A block takes ``chunk`` elements of
    one leaf (the head and tail go with the first), so a leaf takes as many
    blocks as its body or its scalars need.  The leaves go longest first,
    ``max_segments`` to a launch.  Returns [(table, blocks)], one per
    launch: a ``SEGMENT`` array and its blocks in all.  Host code only
    (numpy): the CPU tests check it against an emulation of the kernel's
    block map.
    """
    lanes = 16 // itemsize
    a = np.array(rows, dtype=np.int64).reshape(-1, 6)
    a = a[np.argsort(-a[:, 5], kind="stable")]
    ptrs, n = a[:, :5], a[:, 5]
    off = ptrs[:, 0] % 16
    vec = (ptrs % 16 == off[:, None]).all(axis=1)
    head = np.where(vec, np.minimum((16 - off) % 16 // itemsize, n), 0)
    body = np.where(vec, (n - head) // lanes, 0)
    blocks = np.maximum(-(-body // (chunk // lanes)),
                        -(-(n - body * lanes) // chunk))
    launches = []
    for k in range(0, len(a), max_segments):
        part = slice(k, k + max_segments)
        table = np.empty(len(a[part]), SEGMENT)
        for j, key in enumerate(SEGMENT.names[:6]):
            table[key] = a[part, j]
        table["body"], table["head"] = body[part], head[part]
        table["first_block"] = np.cumsum(blocks[part]) - blocks[part]
        launches.append((table, int(blocks[part].sum())))
    return launches


def _refuse_leaf(i: int, dev: torch.device, *leaves) -> None:
    """Raise what is wrong with leaf ``i`` (x, x_tilde, x_partner) of a
    tree on ``dev``."""
    x = leaves[0]
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"leaf {i}: dtype {x.dtype} is not supported by "
                        f"the CUDA kernel (float32, bfloat16)")
    for key, t in zip(("x", "x_tilde", "x_partner"), leaves):
        if t.device != dev:
            raise ValueError(f"leaf {i}: {key} is on {t.device}, the first "
                             f"leaf on {dev}")
        if t.dtype != x.dtype:
            raise TypeError(f"leaf {i}: {key} is {t.dtype}, x is {x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"leaf {i}: {key} must share x's shape, got "
                             f"{tuple(t.shape)} and {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"leaf {i}: {key} must be contiguous")


def _check_tree(xs, xts, xps, dt) -> dict:
    """The checks of ``mixing_p2p_tree``: three equally long lists of
    contiguous leaves, leaf for leaf of one shape and one supported dtype,
    all on one card with ``dt``, one float32.  Returns {dtype: [(leaf
    index, x, x_tilde and xp addresses, length, shape, strides), ...]}: all
    that the outputs and the table need of a leaf, read once."""
    if not len(xs) == len(xts) == len(xps):
        raise ValueError(f"need as many leaves of x, x_tilde and x_partner, "
                         f"got {len(xs)}, {len(xts)}, {len(xps)}")
    dev = xs[0].device
    card = xs[0].get_device()
    groups: dict = {}
    for i, (x, xt, xp) in enumerate(zip(xs, xts, xps)):
        dtype, shape = x.dtype, x.shape
        if not (dtype in DTYPE_CODE and xt.dtype is dtype
                and xp.dtype is dtype and xt.shape == shape
                and xp.shape == shape and x.get_device() == card
                and xt.get_device() == card and xp.get_device() == card
                and x.is_contiguous() and xt.is_contiguous()
                and xp.is_contiguous()):
            _refuse_leaf(i, dev, x, xt, xp)
        leaf = (i, x.data_ptr(), xt.data_ptr(), xp.data_ptr(), x.numel(),
                shape, x.stride())
        if dtype in groups:
            groups[dtype].append(leaf)
        else:
            groups[dtype] = [leaf]
    if dev.type != "cuda":
        raise ValueError("mixing_p2p runs on CUDA tensors only; CPU tensors "
                         "take the plain version (ops.py)")
    if dt.device != dev or dt.dtype != torch.float32 or dt.numel() != 1:
        raise ValueError(f"dt must be one float32 on {dev}, got "
                         f"{tuple(dt.shape)} {dt.dtype} on {dt.device}")
    return groups


def _tree_outputs(leaves: list, dtype: torch.dtype, dev: torch.device):
    """The outputs of one dtype's ``leaves`` (as ``_check_tree`` groups
    them): views into one fresh buffer per output tree, each at its x's
    offset modulo ``OUT_ALIGN`` bytes.  Returns (out_x views, out_xt views,
    the launches planned for them)."""
    size = _ITEMSIZE[dtype]
    offsets, total = out_offsets([leaf[1] for leaf in leaves],
                                 [leaf[4] for leaf in leaves], size)
    bx = torch.empty(total, dtype=dtype, device=dev)
    bxt = torch.empty_like(bx)
    px, pxt = bx.data_ptr(), bxt.data_ptr()
    vx, vxt, rows = [], [], []
    for (_, x, xt, xp, n, shape, stride), o in zip(leaves, offsets):
        vx.append(bx.as_strided(shape, stride, o))
        vxt.append(bxt.as_strided(shape, stride, o))
        if n:
            rows.append((x, xt, xp, px + o * size, pxt + o * size, n))
    return vx, vxt, plan_launches(rows, size)


def _launch_tree(fn, dtype: torch.dtype, launches: list, dt: torch.Tensor,
                 stream: int, *, eta: float, alpha: float,
                 alpha_t: float) -> None:
    """Issue the planned launches of one dtype on ``stream``."""
    a, at = _dtype_scalar(alpha, dtype), _dtype_scalar(alpha_t, dtype)
    for table, blocks in launches:
        err = fn(DTYPE_CODE[dtype], table.ctypes.data, len(table), blocks,
                 CHUNK, dt.data_ptr(), float(-2.0 * eta), a, at, stream)
        if err != 0:
            raise RuntimeError(f"mixing_p2p launch failed: CUDA error {err}")
        mixing_p2p.launches += 1
        # each leaf's x, x~, xp read once and two outputs written once; dt
        record("mixing_p2p", 0.0,
               5 * int(table["n"].sum()) * _ITEMSIZE[dtype] + 4)


def mixing_p2p_tree(xs, xts, xps, dt: torch.Tensor, *, eta: float,
                    alpha: float, alpha_t: float) -> tuple[list, list]:
    """One gossip event on every leaf of a tree on the card: mix for
    ``dt``, then p2p against ``xps`` (the partner's already mixed leaves).

    xs, xts, xps: lists of leaves, leaf for leaf of one shape, float32 or
    bfloat16, contiguous, at any element alignment, all on one card; dt:
    one float32 on that card, read by the kernel.  alpha and alpha_t are
    rounded here to each leaf's dtype.  Returns two lists of outputs of the
    leaves' shapes: per dtype, views into one fresh buffer per output tree
    (so one output leaf keeps the others' buffer alive); the inputs are
    left as they were.  ONE launch takes up to ``MAX_SEGMENTS`` non-empty
    leaves of one dtype, so a tree of one dtype takes ceil(leaves /
    ``MAX_SEGMENTS``) launches; empty leaves launch nothing.  The launches
    are queued on the current stream and not waited for.  Each adds one to
    ``mixing_p2p.launches``.
    """
    if not xs and not xts and not xps:
        return [], []
    groups = _check_tree(xs, xts, xps, dt)
    dev = xs[0].device
    fn = _entry("mixing_p2p")
    out_x, out_xt = [None] * len(xs), [None] * len(xs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for dtype, leaves in groups.items():
            vx, vxt, launches = _tree_outputs(leaves, dtype, dev)
            _launch_tree(fn, dtype, launches, dt, stream, eta=eta,
                         alpha=alpha, alpha_t=alpha_t)
            for leaf, a, b in zip(leaves, vx, vxt):
                out_x[leaf[0]], out_xt[leaf[0]] = a, b
    return out_x, out_xt


def mixing_p2p(x: torch.Tensor, x_tilde: torch.Tensor,
               x_partner: torch.Tensor, dt: torch.Tensor, *, eta: float,
               alpha: float, alpha_t: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mixing_p2p_tree`` on one tensor of any shape and length: one
    launch (none for an empty tensor), two fresh outputs of x's shape, each
    at x's offset modulo ``OUT_ALIGN`` bytes in its own buffer.  Each launch
    adds one to ``mixing_p2p.launches``, which counts the launches of both
    functions."""
    ox, oxt = mixing_p2p_tree([x], [x_tilde], [x_partner], dt, eta=eta,
                              alpha=alpha, alpha_t=alpha_t)
    return ox[0], oxt[0]


mixing_p2p.launches = 0


# One row of tick_tail_stacked's launch table, laid out as
# csrc/tick_tail_stacked.cu's Segment: a leaf's address, row stride and
# first buffer column, its dims (A, B, C) and their strides, its vector
# body and scalar head (kind KIND_VEC) or its tile (KIND_RUNS), its first
# block and its dtype.  TICK_MAX_SEGMENTS rows take 30,720 bytes: the 32 KB
# of kernel parameters that CUDA 12.1 and later take.
TICK_SEGMENT = np.dtype([("g", "<u8"), ("rs", "<i8"), ("off", "<i8"),
                         ("s", "<i8", (3,)), ("body", "<i8"),
                         ("n", "<i4", (3,)), ("t", "<i4", (3,)),
                         ("head", "<i4"), ("first_block", "<i4"),
                         ("kind", "<i4"), ("gdt", "<i4")])
TICK_MAX_SEGMENTS = 320  # leaves a launch: kMaxSegments in the source
TICK_CHUNK = 4096        # columns a KIND_VEC block: kChunk
RUN_MAX = 32             # elements of a KIND_RUNS tile's run: kRunMax
KIND_VEC, KIND_RUNS = 0, 1
LEAF_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the leaf dtypes a buffer dtype takes: those it embeds exactly, as
# FlatLayout packs them
TICK_LEAVES = {torch.float32: (torch.float32, torch.bfloat16, torch.float16),
               torch.bfloat16: (torch.bfloat16,)}
_INT32 = 2 ** 31 - 1


def leaf_dims(shape, strides) -> list:
    """A worker's leaf (``shape`` and ``strides`` without the worker axis)
    as its fewest dims: size-1 dims dropped, each dim merged into the one
    before it where the two walk memory as one.  Returns [(size, stride)],
    the fastest logical dim last."""
    out = []
    for n, s in zip(shape, strides):
        if n == 1:
            continue
        if out and out[-1][1] == s * n:
            out[-1] = (out[-1][0] * n, s)
        else:
            out.append((n, s))
    return out


def tile_of(dims) -> tuple:
    """The (Ta, Tb, Tc) tile of a KIND_RUNS leaf of dims ((A, sa), (B, sb),
    (C, sc)): a warp takes 32 consecutive columns of C, and a column's Ta *
    Tb tile elements form one run of memory, up to ``RUN_MAX`` long, where
    the leaf has one: along A where sa == 1 (and over whole runs of A along
    B where sb == A: an HWIO view of an OIHW convolution gradient, (kh kw,
    I, O) at strides (1, kh kw, kh kw I), takes Ta = kh kw, Tb = 32 //
    (kh kw)), along B where sb == 1 (a transposed matrix); else a run of
    one.  A tile holds at most 1,024 columns."""
    (a, sa), (b, sb), (_, sc) = dims
    ta = tb = 1
    if sc != 1 and sa == 1:
        ta = min(a, RUN_MAX)
        if ta == a and sb == a:
            tb = min(b, RUN_MAX // a)
    elif sc != 1 and sb == 1:
        tb = min(b, RUN_MAX)
    return ta, tb, 32 * max(1, 32 // (ta * tb))


@functools.lru_cache(maxsize=64)
def plan_tick(geometry: tuple, buf_dtype: torch.dtype, w: int, d: int
              ) -> tuple:
    """The launches of ``tick_tail_stacked`` for leaves of the given
    geometry: one (address mod 16, row stride, first column, columns,
    shape, strides, dtype) a leaf, shape and strides without the worker
    axis.  A leaf whose rows are contiguous at the buffer dtype (its dims
    merge to one of stride 1), with a row stride of whole 16-byte vectors
    and an address that lines up with its columns' 16-byte boundaries, is
    KIND_VEC: a scalar head up to the
    first boundary, a body of vectors, a scalar tail, ``TICK_CHUNK``
    columns a block.  Any other leaf whose dims merge to at most three is
    KIND_RUNS, a tile (``tile_of``) a block.  A launch takes up to
    ``TICK_MAX_SEGMENTS`` leaves of one kind, the KIND_VEC leaves first.
    Returns (a ``TICK_SEGMENT`` table with the addresses 0, launch after
    launch; the leaf index of each row; and int arrays of each launch's
    rows, kind and blocks).  Host code only (numpy): the CPU
    tests check it against an emulation of the kernel's block map."""
    isz = buf_dtype.itemsize
    lanes = 16 // isz
    ends = sorted((off, off + n) for _, _, off, n, *_ in geometry if n)
    for (o0, e0), (o1, _) in zip(ends, ends[1:]):
        if o1 < e0:
            raise ValueError(f"leaves overlap at buffer column {o1}")
    if ends and (ends[0][0] < 0 or ends[-1][1] > d):
        raise ValueError(f"leaves cover columns [{ends[0][0]}, "
                         f"{ends[-1][1]}), outside the buffer's [0, {d})")
    live = [(i, g) for i, g in enumerate(geometry) if g[3]]
    table = np.zeros(len(live), TICK_SEGMENT)
    blocks = np.zeros(len(live), np.int64)
    for row, k, (i, (mod, rs, off, n, shape, strides, dtype)) in zip(
            table, range(len(live)), live):
        dims = leaf_dims(shape, strides)
        if len(dims) > 3:
            raise ValueError(f"leaf {i}: its dims {tuple(shape)} at strides "
                             f"{tuple(strides)} merge to {len(dims)} > 3")
        if max(size for size, _ in dims + [(1, 0)]) > _INT32:
            raise ValueError(f"leaf {i}: a dim of {tuple(shape)} passes "
                             f"2^31 - 1")
        row["rs"], row["off"], row["gdt"] = rs, off, LEAF_CODE[dtype]
        head = min((-off) % lanes, n)
        if (dtype == buf_dtype and len(dims) <= 1
                and (not dims or dims[0][1] == 1)
                and (mod + head * isz) % 16 == 0
                and (w == 1 or rs * isz % 16 == 0)):
            body = (n - head) // lanes
            row["kind"], row["head"], row["body"] = KIND_VEC, head, body
            row["n"], row["s"] = (1, 1, n), (0, 0, 1)
            blocks[k] = max(-(-body // (TICK_CHUNK // lanes)),
                            -(-(n - body * lanes) // TICK_CHUNK))
        else:
            dims = [(1, 0)] * (3 - len(dims)) + dims
            t = tile_of(dims)
            row["kind"], row["t"] = KIND_RUNS, t
            row["n"] = [size for size, _ in dims]
            row["s"] = [stride for _, stride in dims]
            blocks[k] = np.prod([-(-size // tk) for (size, _), tk
                                 in zip(dims, t)])
    order = np.argsort(table["kind"], kind="stable")
    table, blocks = table[order], blocks[order]
    counts, kinds, per_launch = [], [], []
    for kind in (KIND_VEC, KIND_RUNS):
        rows = np.flatnonzero(table["kind"] == kind)
        for k in range(0, len(rows), TICK_MAX_SEGMENTS):
            part = rows[k:k + TICK_MAX_SEGMENTS]
            table["first_block"][part] = np.cumsum(blocks[part]) \
                - blocks[part]
            if blocks[part].sum() > _INT32:
                raise ValueError(f"a launch of {blocks[part].sum()} blocks "
                                 f"passes the grid's 2^31 - 1")
            counts.append(len(part))
            kinds.append(kind)
            per_launch.append(blocks[part].sum())
    leaf = np.asarray([i for i, _ in live], np.int64)[order]
    return table, leaf, (np.asarray(counts, np.int32),
                         np.asarray(kinds, np.int32),
                         np.asarray(per_launch, np.int64))


def _tick_geometry(x: torch.Tensor, leaves, offsets) -> tuple:
    """The checks of the leaves of ``tick_tail_stacked`` and their
    geometry for ``plan_tick``: each on x's card, of a dtype the buffer
    embeds, (W, *shape)."""
    w = x.shape[0]
    if len(leaves) != len(offsets):
        raise ValueError(f"need one offset a leaf, got {len(leaves)} leaves "
                         f"and {len(offsets)} offsets")
    allowed = TICK_LEAVES[x.dtype]
    geometry = []
    for i, (leaf, off) in enumerate(zip(leaves, offsets)):
        if leaf.device != x.device:
            raise ValueError(f"leaf {i} is on {leaf.device}, x on "
                             f"{x.device}")
        if leaf.dtype not in allowed:
            raise TypeError(f"leaf {i}: dtype {leaf.dtype} does not embed "
                            f"in a {x.dtype} buffer")
        if leaf.dim() < 1 or leaf.shape[0] != w:
            raise ValueError(f"leaf {i} must be (W, ...) with W = {w}, got "
                             f"{tuple(leaf.shape)}")
        geometry.append((leaf.data_ptr() % 16, leaf.stride(0), int(off),
                         leaf.numel() // w, tuple(leaf.shape[1:]),
                         leaf.stride()[1:], leaf.dtype))
    return geometry


def tick_tail_stacked(x: torch.Tensor, x_tilde: torch.Tensor, leaves,
                      offsets, gscale: torch.Tensor,
                      coeff: torch.Tensor | None, *, gamma: float):
    """The tail of a gradient tick on the card, in one pass: the descent of
    both buffers by the gradient leaves, the metrics row, the trailing mix.

    x, x_tilde: (W, D) float32 or bfloat16, contiguous, 16-byte aligned,
    D % 128 == 0; leaves: the gradient leaves (W, *shape), read in place at
    any strides whose per-worker dims merge to at most three, of the
    buffer's dtype or one it embeds (float16 or bfloat16 in a float32
    buffer), leaf i at buffer columns offsets[i] onwards (FlatLayout's
    specs; the columns past the leaves, the padding, are not touched);
    gscale: (W,) float32, each row's gradient scale; coeff: (W,) float32,
    the trailing mix's coefficient (``a2cid2.mixing_coeff(eta,
    dt_next)``), or None for eta == 0 (no mix: the baseline's buffers stay
    exactly the descent's); gamma, rounded here to the buffer dtype.

    x and x_tilde are updated IN PLACE and returned, with the row's
    consensus and mean squared norm, two 0-dim float32 views of one fresh
    tensor.  x and x~ are bit for bit ``ref.tick_tail_stacked_ref``'s; the
    row agrees to the rounding of its sums (the kernel adds in double,
    each column at once).  The launches (one of the pass for each kind of
    leaf present, more past ``TICK_MAX_SEGMENTS`` leaves of a kind, and
    one of the row's sum) are queued on the current stream and not waited
    for.  Each call adds one to
    ``tick_tail_stacked.launches``.
    """
    vectors = {"gscale": (gscale, torch.float32, "row")}
    if coeff is not None:
        vectors["coeff"] = (coeff, torch.float32, "row")
    _check_rows("tick_tail_stacked", x, {"x_tilde": x_tilde}, vectors)
    w, d = x.shape
    table, leaf, (counts, kinds, blocks) = plan_tick(
        tuple(_tick_geometry(x, leaves, offsets)), x.dtype, w, d)
    table = table.copy()
    table["g"] = [leaves[i].data_ptr() for i in leaf]
    partials = torch.empty((int(blocks.sum()), 2), dtype=torch.float64,
                           device=x.device)
    row = torch.empty(2, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry("tick_tail_stacked")(
            DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(), w, d,
            table.ctypes.data, len(blocks), counts.ctypes.data,
            kinds.ctypes.data, blocks.ctypes.data, gscale.data_ptr(),
            None if coeff is None else coeff.data_ptr(),
            dtype_scalar(gamma, x.dtype),
            float(np.float32(d) / np.float32(w * d)),
            float(np.float32(1.0) / np.float32(w)), partials.data_ptr(),
            row.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"tick_tail_stacked launch failed: CUDA error "
                           f"{err}")
    tick_tail_stacked.launches += 1
    # each leaf read once at its dtype; x, x~ read and written once;
    # gscale (and coeff) read; the partials written and read; the row
    record("tick_tail_stacked", 0.0,
           sum(leaf.numel() * leaf.element_size() for leaf in leaves)
           + 4 * x.numel() * x.element_size()
           + (1 + (coeff is not None)) * w * 4 + 2 * partials.numel() * 8
           + 8)
    return x, x_tilde, row[0], row[1]


tick_tail_stacked.launches = 0
