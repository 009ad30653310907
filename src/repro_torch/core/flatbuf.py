"""Flat-buffer layout for worker-stacked pytree state.

The gossip-event loop is the unit of cost: every event touches the whole
replica.  ``FlatLayout`` packs the replica into ONE contiguous buffer with a
static layout spec, so an event is a single fused sweep:

  * stacked form — leaves (W, *shape) -> one (W, D) buffer, worker-major;
  * local form   — leaves (*shape)    -> one (D,) vector;
  * worlds form  — leaves (B, W, *shape) -> one (B, W, D) buffer: B
    independent worlds' replicas on a leading axis (the world-batched
    replay), with the stacked form's layout below it.

D is the sum of leaf sizes rounded up to a multiple of ``LANE`` (128), so
every row starts 16-byte aligned for any buffer dtype and the hand kernel
can use 16-byte vector loads.  Padding columns are zeros and stay zero under
mixing, p2p and gradient updates (all linear with a 0 fixed point).

Leaves are visited in the JAX package's order (sorted dict keys, see
``tree``), so a packed buffer equals the JAX ``FlatLayout.pack`` output
column for column.  The buffer dtype is inferred as in the JAX package: a
uniform-dtype tree packs at its own precision, mixed floating dtypes pack at
the narrowest dtype that embeds every leaf exactly (f32, else f64), anything
else raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import PyTree, TreeDef, tree_flatten

LANE = 128  # row width granule: 16-byte aligned rows for every dtype

# floating dtypes whose values embed losslessly in each buffer dtype
_EXACT_EMBED = {
    torch.float16: {torch.float16},
    torch.bfloat16: {torch.bfloat16},
    torch.float32: {torch.float32, torch.bfloat16, torch.float16},
    torch.float64: {torch.float64, torch.float32, torch.bfloat16,
                    torch.float16},
}


def _infer_buf_dtype(dtypes: set) -> torch.dtype:
    """Narrowest buffer dtype that round-trips every leaf dtype exactly."""
    if len(dtypes) == 1:
        (d,) = dtypes
        if d in _EXACT_EMBED:
            return d
        raise TypeError(f"leaf dtype {d} is not a supported buffer dtype")
    for buf in (torch.float32, torch.float64):
        if dtypes <= _EXACT_EMBED[buf]:
            return buf
    raise TypeError("no buffer dtype embeds leaf dtypes "
                    f"{sorted(map(str, dtypes))} exactly")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static placement of one pytree leaf inside the flat buffer."""

    offset: int              # start column in the flat axis
    size: int                # number of elements (= prod(shape))
    shape: tuple[int, ...]   # per-worker shape (no leading worker axis)
    dtype: torch.dtype       # original leaf dtype, restored on unpack


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static pack/unpack spec between a replica pytree and a flat buffer."""

    treedef: TreeDef
    specs: tuple[LeafSpec, ...]
    d: int                   # padded flat width (multiple of ``lane``)
    d_real: int              # sum of leaf sizes (<= d)
    buf_dtype: torch.dtype

    @classmethod
    def from_pytree(cls, tree: PyTree, *, stacked: bool = False,
                    worlds: bool = False,
                    buf_dtype: torch.dtype | None = None,
                    lane: int = LANE) -> "FlatLayout":
        """Build a layout from a template pytree (shapes and dtypes only).

        stacked=True strips a leading worker axis from every leaf;
        worlds=True strips a leading (world, worker) pair (the per-replica
        layout is the same either way).  buf_dtype=None infers the
        narrowest exact buffer dtype; passing one explicitly still
        validates exactness.
        """
        leaves, treedef = tree_flatten(tree)
        if buf_dtype is None:
            buf_dtype = _infer_buf_dtype({a.dtype for a in leaves})
        lead = 2 if worlds else (1 if stacked else 0)
        specs = []
        off = 0
        for leaf in leaves:
            shape = tuple(leaf.shape[lead:])
            if leaf.dtype not in _EXACT_EMBED.get(buf_dtype, ()):
                raise TypeError(
                    f"leaf dtype {leaf.dtype} does not round-trip exactly "
                    f"through buffer dtype {buf_dtype}")
            size = math.prod(shape)
            specs.append(LeafSpec(off, size, shape, leaf.dtype))
            off += size
        d = ((off + lane - 1) // lane) * lane if off else lane
        return cls(treedef=treedef, specs=tuple(specs), d=d, d_real=off,
                   buf_dtype=buf_dtype)

    def pack(self, tree: PyTree) -> torch.Tensor:
        """Stacked pytree (leaves (W, *shape)) -> fresh (W, D) buffer."""
        leaves = self.treedef.flatten_up_to(tree)
        w = leaves[0].shape[0]
        buf = torch.empty((w, self.d), dtype=self.buf_dtype,
                          device=leaves[0].device)
        for leaf, s in zip(leaves, self.specs):
            buf[:, s.offset:s.offset + s.size] = leaf.reshape(w, s.size)
        buf[:, self.d_real:] = 0
        return buf

    def unpack(self, buf: torch.Tensor) -> PyTree:
        """(W, D) buffer -> stacked pytree with original shapes/dtypes.
        Leaves of the buffer dtype are views into ``buf``."""
        w = buf.shape[0]
        return self.treedef.unflatten([
            buf[:, s.offset:s.offset + s.size]
            .to(s.dtype).reshape((w,) + s.shape) for s in self.specs])

    def pack_local(self, tree: PyTree) -> torch.Tensor:
        """Replica pytree (leaves (*shape)) -> fresh (D,) vector."""
        leaves = self.treedef.flatten_up_to(tree)
        vec = torch.zeros((self.d,), dtype=self.buf_dtype,
                          device=leaves[0].device)
        for leaf, s in zip(leaves, self.specs):
            vec[s.offset:s.offset + s.size] = leaf.reshape(s.size)
        return vec

    def unpack_local(self, vec: torch.Tensor) -> PyTree:
        """(D,) vector -> replica pytree with original shapes/dtypes."""
        return self.treedef.unflatten([
            vec[s.offset:s.offset + s.size].to(s.dtype).reshape(s.shape)
            for s in self.specs])

    def pack_worlds(self, tree: PyTree) -> torch.Tensor:
        """World-batched pytree (leaves (B, W, *shape)) -> fresh (B, W, D)
        buffer."""
        leaves = self.treedef.flatten_up_to(tree)
        b, w = leaves[0].shape[:2]
        buf = torch.empty((b, w, self.d), dtype=self.buf_dtype,
                          device=leaves[0].device)
        for leaf, s in zip(leaves, self.specs):
            buf[:, :, s.offset:s.offset + s.size] = leaf.reshape(b, w, s.size)
        buf[:, :, self.d_real:] = 0
        return buf

    def unpack_worlds(self, buf: torch.Tensor) -> PyTree:
        """(B, W, D) buffer -> world-batched pytree.  Leaves of the buffer
        dtype are views into ``buf``."""
        b, w = buf.shape[:2]
        return self.treedef.unflatten([
            buf[:, :, s.offset:s.offset + s.size]
            .to(s.dtype).reshape((b, w) + s.shape) for s in self.specs])


# ---------------------------------------------------------------------------
# snapshot ring (unreliable-channel stale reads)
# ---------------------------------------------------------------------------
# The channel's delay axis reads partner values from past flat states.  The
# replay keeps an (H, W, D) ring of the last H snapshots, written at each
# gradient tick (one snapshot per round).  Slot indices are schedule data
# resolved on the host ((r - staleness) mod H); the loop only gathers and
# copies.  Unlike the JAX package's ring (an immutable broadcast), this one
# owns its (H, W, D) storage: ``ring_push`` writes a slot in place, which
# through an ``expand`` view would overwrite every slot at once.

def ring_init(buf: torch.Tensor, horizon: int) -> torch.Tensor:
    """(H, W, D) ring with its own storage, every slot a copy of ``buf``
    (staleness clamping guarantees no slot is read before round r >= 1 has
    written it anyway)."""
    if horizon <= 0:
        raise ValueError(f"ring_init needs horizon >= 1, got {horizon}")
    return buf.unsqueeze(0).repeat((horizon,) + (1,) * buf.dim())


def ring_push(ring: torch.Tensor, buf: torch.Tensor, pos: int
              ) -> torch.Tensor:
    """Copy ``buf`` into slot ``pos`` (= round mod H, host-resolved), in
    place; the ring never aliases ``buf``.  Returns the ring."""
    ring[pos].copy_(buf)
    return ring


def ring_read(ring: torch.Tensor, buf: torch.Tensor, partner: torch.Tensor,
              src_slot: torch.Tensor) -> torch.Tensor:
    """(W, ...) partner values under staleness (``buf`` (W, ...), ``ring``
    (H, W, ...): a flat buffer or one leaf of a stacked pytree).

    ``src_slot[w]`` selects where worker w's read is served from: the
    sentinel ``H`` (= ring depth) means a fresh read of the partner's
    current row in ``buf``; ``0..H-1`` name a ring slot.  Two row gathers
    plus a select, as in the JAX package.
    """
    h = ring.shape[0]
    partner = partner.long()
    src_slot = src_slot.long()
    fresh = buf.index_select(0, partner)
    stale = ring[src_slot.clamp(max=h - 1), partner]
    sel = (src_slot < h).reshape((-1,) + (1,) * (buf.dim() - 1))
    return torch.where(sel, stale, fresh)


# -- world-batched ring (B, H, W, D): one snapshot ring per world.  The
# batched stream aligns the worlds' gradient ticks, so a push writes one
# shared slot in every world.  Like ``ring_init`` it owns its storage (the
# JAX package seeds it with an immutable broadcast).

def ring_init_worlds(buf: torch.Tensor, horizon: int) -> torch.Tensor:
    """(B, H, W, D) ring with its own storage, every slot of world b a copy
    of ``buf[b]``."""
    if horizon <= 0:
        raise ValueError(f"ring_init_worlds needs horizon >= 1, "
                         f"got {horizon}")
    return buf.unsqueeze(1).repeat((1, horizon) + (1,) * (buf.dim() - 1))


def ring_push_worlds(ring: torch.Tensor, buf: torch.Tensor, pos: int
                     ) -> torch.Tensor:
    """Copy each world's (W, D) buffer into slot ``pos`` (shared, = round
    mod H) of its own ring, in place.  Returns the ring."""
    ring[:, pos].copy_(buf)
    return ring


def ring_read_worlds(ring: torch.Tensor, buf: torch.Tensor,
                     partner: torch.Tensor, src_slot: torch.Tensor
                     ) -> torch.Tensor:
    """(B, W, D) partner values under staleness, per world: ``ring_read``
    with a leading world axis (``partner`` and ``src_slot`` (B, W), the
    partners local to each world)."""
    h = ring.shape[1]
    partner = partner.long()
    src_slot = src_slot.long()
    b_idx = torch.arange(buf.shape[0], device=buf.device)[:, None]
    fresh = buf[b_idx, partner]
    stale = ring[b_idx, src_slot.clamp(max=h - 1), partner]
    return torch.where((src_slot < h)[:, :, None], stale, fresh)


# -- bounded-staleness permute ring: the cross-shard half of the sharded
# worlds replay (``launch/mesh_replay.py``).  Each shard publishes the
# (B, nb, D) block of boundary rows its peers read this step; one gather
# over the shards stacks every shard's block into an (NS, B, nb, D) pool,
# which readers index by (hop, pool_pos): hop h holds the block published
# by shard (self - h) mod NS, matching ``events.ShardPlan.hop``.

def ring_pool_exchange(vals, mesh) -> list[torch.Tensor]:
    """All-to-all the published boundary blocks over ``mesh``'s shards.

    ``vals`` holds one (B, nb, D) block per shard of this process (in
    ``mesh.shards`` order, each on its shard's device); returns each of
    those shards' HOP-ordered pool: ``pool[h]`` is the block published by
    shard ``(self - h) mod NS``, the block an ``h``-step ring walk (shard
    i -> i + 1 mod NS) would deliver, because the host shard plan
    (``events.shard_partition``) addresses cross reads by hop count.  The
    exchange is ONE ``mesh.all_gather``; the hop order is then a window of
    the gathered blocks reversed and laid out twice, so shards that share
    a gather (local shards on one device) share that copy and take views
    of it.  With one shard there is no collective and the pool is the
    local block alone.
    """
    ns = mesh.n_shards
    if ns == 1:
        return [v[None] for v in vals]
    twice: dict = {}
    pools = []
    for u, g in zip(mesh.shards, mesh.all_gather(vals)):
        if id(g) not in twice:
            # twice[k] = g[(ns - 1 - k) mod ns], for k < 2 ns
            twice[id(g)] = torch.stack([g[(-1 - k) % ns]
                                        for k in range(2 * ns)])
        # pool[h] = twice[ns - 1 - u + h] = g[(u - h) mod ns]
        start = ns - 1 - u
        pools.append(twice[id(g)][start:start + ns])
    return pools
