"""Per-round telemetry: the replay's flight recorder, ported from
``repro.core.telemetry``.

A ``Telemetry(...)`` spec on ``World`` / ``Simulator.run_schedule`` /
``Simulator.run_worlds`` makes the replay emit per-round metric columns as
``trace.telemetry`` without changing any number of the replay.

Two kinds of columns, split by where the information lives:

  * **runtime columns** (they depend on the evolving state): per-round
    counts of APPLIED and REJECTED directed reads and the first two
    moments of the admitted channel-delta norms.  The simulator's loops
    fold each comm step into a small f32 accumulator on the device
    (scalars serially, (B,) world-batched) and emit and reset it at each
    gradient tick, as they do the defense counters.
  * **schedule columns** (pure schedule data): scheduled and dropped read
    counts, the staleness histogram, per-worker participation and the
    cross-shard reads.  :func:`schedule_columns` derives them on the host
    from the same arrays the replay consumes, so they are exact.

Bytes moved are runtime x layout: each applied directed read moves one
flat row, ``row_bytes`` from the ``FlatLayout`` dtype widths, so
``bytes_moved = applied * row_bytes``, attached after the replay returns.

The host part (the spec, the schedule columns, the summary) is the JAX
package's numpy code; the runtime columns are torch tensors on the
replay's device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, NamedTuple

import numpy as np
import torch

from .channel import DROP_KEY, STALE_KEY
from .tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Declarative, serializable per-round telemetry spec.

    staleness_buckets — upper edges (inclusive) of the staleness
      histogram; reads bucket as [fresh, <=b1, <=b2, ..., overflow].
    norm_moments — record sum and sum-of-squares of admitted delta
      norms per round.
    participation — per-worker directed-read counts per round.
    bytes_moved — applied reads x flat-row bytes per round.
    shards — worker-shard count of the replay: > 1 splits the bytes
      column into intra-shard and cross-shard moved bytes (schedule
      accounting); 0 keeps the unsharded trace shape.

    Hashable (tuple fields only), so one spec is shared by every world of
    a batch.
    """

    staleness_buckets: tuple[int, ...] = (1, 2, 4, 8)
    norm_moments: bool = True
    participation: bool = True
    bytes_moved: bool = True
    shards: int = 0

    def __post_init__(self):
        try:
            edges = tuple(int(b) for b in self.staleness_buckets)
        except (TypeError, ValueError):
            raise ValueError("Telemetry.staleness_buckets must be ints, "
                             f"got {self.staleness_buckets!r}") from None
        if any(b <= 0 for b in edges) or list(edges) != sorted(set(edges)):
            raise ValueError("Telemetry.staleness_buckets must be strictly "
                             f"increasing positive ints, got {edges}")
        object.__setattr__(self, "staleness_buckets", edges)
        if int(self.shards) < 0:
            raise ValueError(f"Telemetry.shards must be >= 0, "
                             f"got {self.shards}")
        object.__setattr__(self, "shards", int(self.shards))

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"staleness_buckets": list(self.staleness_buckets),
                "norm_moments": self.norm_moments,
                "participation": self.participation,
                "bytes_moved": self.bytes_moved,
                "shards": self.shards}

    @staticmethod
    def from_dict(d: dict) -> "Telemetry":
        return Telemetry(
            staleness_buckets=tuple(d.get("staleness_buckets", (1, 2, 4, 8))),
            norm_moments=d.get("norm_moments", True),
            participation=d.get("participation", True),
            bytes_moved=d.get("bytes_moved", True),
            shards=d.get("shards", 0))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Telemetry":
        return Telemetry.from_dict(json.loads(s))


class TelemetryTrace(NamedTuple):
    """Per-round telemetry columns of one replay.

    Runtime columns (f32 tensors on the replay's device, (R,) serial /
    (B, R) world-batched): ``applied``, ``rejected``, ``norm_sum``,
    ``norm_sq_sum``, ``bytes_moved``.  Schedule columns (numpy, exact):
    ``scheduled``, ``dropped`` (same shapes), ``stale_hist`` ((R, nb) /
    (B, R, nb)) and ``participation`` ((R, n) / (B, R, n)).  ``row_bytes``
    is the flat-row transfer size the bytes column used.
    """

    applied: Any            # admitted directed reads per round
    rejected: Any           # robust/defense-rejected directed reads
    norm_sum: Any           # sum of admitted delta norms (None if off)
    norm_sq_sum: Any        # sum of squared admitted delta norms
    scheduled: Any          # directed reads the schedule asked for
    dropped: Any            # reads erased by channel drops
    stale_hist: Any         # staleness histogram (None if no buckets)
    participation: Any      # (.., n) per-worker read counts (None if off)
    bytes_moved: Any        # applied * row_bytes (None if off)
    row_bytes: int = 0
    # the shard split (None unless ``Telemetry.shards`` > 1): each
    # surviving scheduled read moves one flat row over exactly one path, an
    # intra-shard gather or a boundary hop, before any rejection
    cross_reads: Any = None  # boundary reads per round
    bytes_intra: Any = None  # (scheduled - dropped - cross) * row_bytes
    bytes_cross: Any = None  # cross_reads * row_bytes


def row_bytes_of(layout=None, tree=None) -> int:
    """Bytes one directed partner read moves: the real (unpadded) flat row
    width times the buffer dtype's width, from a ``FlatLayout`` when the
    engine path built one, else summed over the worker-stacked tree's
    leaves."""
    if layout is not None:
        return int(layout.d_real) * layout.buf_dtype.itemsize
    if tree is not None:
        total = 0
        for leaf in tree_leaves(tree):
            # leaves are (n, ...) worker-stacked: one row is the per-worker
            # slice
            per_row = int(np.prod(leaf.shape[1:])) if leaf.dim() > 1 else 1
            total += per_row * leaf.element_size()
        return total
    return 0


def stale_bucket_edges(tel: Telemetry) -> np.ndarray:
    return np.asarray(tel.staleness_buckets, np.int64)


def _involved(partners: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(R, K, n) directed-read involvement from schedule arrays."""
    n = partners.shape[-1]
    return (partners != np.arange(n)) & mask[..., None]


def cross_shard_reads(partners: np.ndarray, mask: np.ndarray,
                      n_shards: int) -> np.ndarray:
    """(R,) cross-shard boundary-read counts of schedule arrays under an
    equal ``n_shards``-way worker split; zeros when the split is trivial
    or ragged (a ragged worker axis falls back to one device, so nothing
    crosses a boundary)."""
    partners = np.asarray(partners)
    R, K, n = partners.shape
    if n_shards <= 1 or n % n_shards != 0:
        return np.zeros(R, np.int64)
    ws = n // n_shards
    rdr = np.arange(n, dtype=np.int64)
    cross = ((partners != rdr)
             & (partners.astype(np.int64) // ws != rdr // ws)
             & np.asarray(mask)[..., None])
    return cross.reshape(R, -1).sum(axis=1).astype(np.int64)


def schedule_columns(tel: Telemetry, sched) -> dict:
    """Host-side exact columns from one compiled ``events.Schedule``.

    Returns numpy arrays keyed ``scheduled`` (R,), ``dropped`` (R,),
    ``stale_hist`` (R, len(buckets)+2), ``participation`` (R, n) and
    ``cross_reads`` (R,): the last three ``None`` when the spec turns them
    off."""
    partners = np.asarray(sched.partners)
    mask = np.asarray(sched.event_mask)
    R, K, n = partners.shape
    inv = _involved(partners, mask)
    extras = sched.extras_dict()

    drop = extras.get(DROP_KEY)
    dropped = (np.asarray(drop).astype(bool) & mask[..., None]) \
        .reshape(R, -1).sum(axis=1).astype(np.int64) \
        if drop is not None else np.zeros(R, np.int64)
    # drops rewrite the partner involution to identity at compile time
    # (channel.py), so ``inv`` counts only SURVIVING reads: the erased
    # endpoints are added back so that ``scheduled`` means "asked for" and
    # applied + rejected + dropped == scheduled balances
    scheduled = inv.reshape(R, -1).sum(axis=1).astype(np.int64) + dropped

    stale_hist = None
    if tel.staleness_buckets:
        stale = extras.get(STALE_KEY)
        s = np.asarray(stale, np.int64) if stale is not None \
            else np.zeros((R, K, n), np.int64)
        edges = stale_bucket_edges(tel)
        nb = len(edges) + 2
        # bucket 0 = fresh reads, buckets 1..k = s <= edge_k, last = beyond
        bucket = np.searchsorted(edges, np.where(s > 0, s, 0),
                                 side="left") + 1
        bucket = np.where(s > 0, bucket, 0)
        stale_hist = np.zeros((R, nb), np.int64)
        for b in range(nb):
            stale_hist[:, b] = (inv & (bucket == b)).reshape(R, -1) \
                .sum(axis=1)

    participation = inv.sum(axis=1).astype(np.int64) \
        if tel.participation else None
    cross = cross_shard_reads(partners, mask, tel.shards) \
        if tel.shards > 1 else None
    return {"scheduled": scheduled, "dropped": dropped,
            "stale_hist": stale_hist, "participation": participation,
            "cross_reads": cross}


def batch_schedule_columns(tel: Telemetry, scheds) -> dict:
    """Stack :func:`schedule_columns` over B worlds -> (B, R, ...)."""
    cols = [schedule_columns(tel, s) for s in scheds]

    def stack(key):
        vals = [c[key] for c in cols]
        return None if vals[0] is None else np.stack(vals)

    return {k: stack(k) for k in ("scheduled", "dropped", "stale_hist",
                                  "participation", "cross_reads")}


def finalize_trace(tel: Telemetry, runtime, sched_cols: dict,
                   row_bytes: int) -> TelemetryTrace:
    """Assemble the public :class:`TelemetryTrace` from the replay's raw
    runtime tuple ``(applied, rejected, norm_sum, norm_sq_sum)`` and the
    host-side schedule columns."""
    applied, rejected, norm_sum, norm_sq = runtime
    if not tel.norm_moments:
        norm_sum = norm_sq = None
    # f32 arithmetic, as JAX multiplies its f32 column by a weak Python
    # scalar: the row width is rounded to f32 first (exact below 2^24)
    bytes_moved = applied * torch.tensor(
        float(row_bytes), dtype=torch.float32, device=applied.device) \
        if tel.bytes_moved else None
    cross = sched_cols.get("cross_reads")
    bytes_intra = bytes_cross = None
    if tel.bytes_moved and cross is not None:
        survived = sched_cols["scheduled"] - sched_cols["dropped"]
        bytes_cross = cross * float(row_bytes)
        bytes_intra = (survived - cross) * float(row_bytes)
    return TelemetryTrace(
        applied=applied, rejected=rejected,
        norm_sum=norm_sum, norm_sq_sum=norm_sq,
        scheduled=sched_cols["scheduled"], dropped=sched_cols["dropped"],
        stale_hist=sched_cols["stale_hist"],
        participation=sched_cols["participation"],
        bytes_moved=bytes_moved,
        row_bytes=int(row_bytes) if tel.bytes_moved else 0,
        cross_reads=cross, bytes_intra=bytes_intra,
        bytes_cross=bytes_cross)


def _host(a):
    """A column as numpy at its own dtype (device tensors moved to the
    CPU), so the digest's numpy arithmetic is the JAX package's."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def trace_summary(tt: TelemetryTrace) -> dict:
    """JSON-able digest of a telemetry trace (benchmark artifacts)."""
    def tot(a):
        return None if a is None else float(_host(a).sum())

    applied = _host(tt.applied).astype(np.float64)
    out = {
        "applied_total": float(applied.sum()),
        "rejected_total": tot(tt.rejected),
        "scheduled_total": tot(tt.scheduled),
        "dropped_total": tot(tt.dropped),
        "row_bytes": tt.row_bytes,
        "bytes_moved_total": tot(tt.bytes_moved),
    }
    if tt.cross_reads is not None:
        out["cross_reads_total"] = tot(tt.cross_reads)
        out["bytes_intra_total"] = tot(tt.bytes_intra)
        out["bytes_cross_total"] = tot(tt.bytes_cross)
    if tt.norm_sum is not None:
        # a diverged world (a scale-attack arm) pushes its delta norms to
        # inf/nan; digest over the finite rounds only, so that one blown-up
        # arm does not null the whole grid's moment
        ns = _host(tt.norm_sum).astype(np.float64)
        fin = np.isfinite(ns)
        napp = float(applied[fin].sum())
        out["admitted_norm_mean"] = float(ns[fin].sum()) / max(napp, 1.0)
        if not fin.all():
            out["norm_finite_frac"] = float(fin.mean())
    if tt.stale_hist is not None:
        h = _host(tt.stale_hist)
        out["stale_hist_total"] = [int(v) for v in
                                   h.reshape(-1, h.shape[-1]).sum(axis=0)]
    return out
