"""Replay meshes: the worker axis of the sharded worlds replay
(``launch/mesh_replay.py``) split over devices.

A mesh is 1-D, with one named axis.  It gives the replay three
operations and nothing else: the indices of the shards this process
holds (``shards``, with their ``devices``), ``all_gather`` of one block
per shard, and ``sum`` of one partial per shard.  Two meshes implement
them:

  * :class:`LocalMesh` (``make_replay_mesh``) — one process holds every
    shard, one device per shard.  A device may repeat, so four shards can
    share one card, and CPU shards serve the tests.  The collectives are
    copies between the shards' devices, made once per distinct device.
  * :class:`RankMesh` (``make_rank_mesh``) — one ``torch.distributed``
    rank per shard, each on its own device (NCCL on the card, gloo on the
    CPU), as ``torchrun`` launches one process per card.  The collectives
    are ``all_gather`` and ``all_reduce`` over the process group.

The replay body loops over ``mesh.shards`` either way: a local mesh hands
it NS shards, a rank mesh one.

The production meshes of the dry run (``make_production_mesh``,
``make_gossip_mesh``) are :class:`AbstractMesh`es: axis names and sizes,
no devices, as the dry run needs no card; ``rules_for`` picks a mesh's
partition rules (``sharding.py``) and ``mesh_devices`` counts its devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .. import sharding
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes with no devices behind it (the dry run's
    production meshes)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) multi-pod."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_gossip_mesh(n_workers: int = 8, data: int = 8, model: int = 8
                     ) -> AbstractMesh:
    """Decentralized mesh: ``n_workers`` slices on a gossip graph, each an
    FSDP(data) x TP(model) synchronous island.  Default (8, 8, 8) = 512
    devices, 8 workers: a ring of 8 has chi1 ~ 3.5 >> chi2 ~ 0.9, so
    A2CiD2 bites."""
    return AbstractMesh(("worker", "data", "model"), (n_workers, data, model))


def rules_for(mesh) -> dict:
    """The partition rules of a mesh, by its axis names (any mesh of this
    module: abstract, local or rank)."""
    axes = tuple(mesh.axis_names)
    if "pod" in axes:
        return dict(sharding.MULTI_POD_RULES)
    if "worker" in axes:
        # a pure replay mesh (worker axis only) shards the flat worker
        # banks and replicates everything else; a (worker, data, model)
        # gossip mesh keeps the model-sharding rules
        if axes == ("worker",):
            return dict(sharding.REPLAY_RULES)
        return dict(sharding.GOSSIP_RULES)
    return dict(sharding.SINGLE_POD_RULES)


def mesh_devices(mesh) -> int:
    """The number of devices (shards) of a mesh."""
    return math.prod(mesh.shape.values())


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` made ``cuda:<current>``, so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Every shard in this process: shard u lives on ``devices[u]``."""

    devices: tuple[torch.device, ...]
    axis: str = "worker"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def shards(self) -> range:
        return range(len(self.devices))

    def all_gather(self, blocks: Sequence[torch.Tensor]
                   ) -> list[torch.Tensor]:
        """For each shard, the (NS, ...) stack of every shard's block in
        shard order, on the shard's device.  Shards on one device share
        one stack (read it, do not write it)."""
        stacks: dict = {}
        for dev in self.devices:
            if dev not in stacks:
                stacks[dev] = torch.stack([b.to(dev) for b in blocks])
        return [stacks[dev] for dev in self.devices]

    def sum(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """For each shard, the sum of every shard's partial, added in shard
        order on the shard's device (shared by the shards of one device)."""
        sums: dict = {}
        for dev in self.devices:
            if dev not in sums:
                acc = parts[0].to(dev)
                for p in parts[1:]:
                    acc = acc + p.to(dev)
                sums[dev] = acc
        return [sums[dev] for dev in self.devices]


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One shard per ``torch.distributed`` rank: this process holds shard
    ``rank`` of ``size`` on ``device``."""

    device: torch.device
    rank: int
    size: int
    axis: str = "worker"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    @property
    def n_shards(self) -> int:
        return self.size

    @property
    def shards(self) -> range:
        return range(self.rank, self.rank + 1)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return (self.device,)

    def all_gather(self, blocks: Sequence[torch.Tensor]
                   ) -> list[torch.Tensor]:
        import torch.distributed as dist
        (block,) = blocks
        block = block.contiguous()
        out = torch.empty((self.size,) + tuple(block.shape),
                          dtype=block.dtype, device=block.device)
        dist.all_gather(list(out.unbind(0)), block)
        return [out]

    def sum(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        import torch.distributed as dist
        (part,) = parts
        out = part.clone()
        dist.all_reduce(out)
        return [out]


def make_replay_mesh(n_shards: int | None = None, *,
                     devices: Sequence | None = None,
                     axis: str = "worker") -> LocalMesh:
    """A 1-D replay mesh whose shards all live in this process.

    Sized from ``torch.cuda.device_count()`` (it raises without a card),
    or from an explicit ``devices`` list, which may repeat a device (four
    shards on one card, or ``["cpu"] * 4``); the first ``n_shards``
    devices are taken."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    avail = len(devices)
    if n_shards is None:
        n_shards = avail
    if not 1 <= n_shards <= avail:
        raise ValueError(f"make_replay_mesh needs 1 <= n_shards <= "
                         f"{avail} local devices, got {n_shards}")
    return LocalMesh(tuple(devices[:n_shards]), axis)


def make_rank_mesh(device=None, *, axis: str = "worker") -> RankMesh:
    """A 1-D replay mesh of one shard per rank of the initialised default
    ``torch.distributed`` process group: this rank's shard lives on
    ``device`` (default: the current card, as ``torchrun`` scripts set it
    with ``torch.cuda.set_device``; pass ``"cpu"`` under gloo)."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_rank_mesh needs an initialised "
                           "torch.distributed process group")
    dev = _indexed(resolve_device("cuda" if device is None else device))
    return RankMesh(dev, dist.get_rank(), dist.get_world_size(), axis)
