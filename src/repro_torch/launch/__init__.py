"""Entry points: the gossip trainers, the LM train / prefill / serve steps,
the training launcher (``launch.train``) and the serving path: the
``generate`` CLI (``launch.serve``), continuous batching
(``launch.batching.ContinuousBatcher`` over a host ``SlotScheduler``) and
the gossip-serving fleet (``launch.fleet.GossipFleet``), the sharded
worlds replay (``launch.mesh_replay.MeshReplay`` on a ``launch.mesh``
replay mesh), and the dry run on the meta device (``launch.dryrun``, over
``launch.steps.bundle_for``, the partition specs of ``launch.shardings``
and the abstract production meshes of ``launch.mesh``).
``launch.serve``, ``launch.train`` and ``launch.dryrun`` are CLIs
(``python -m``), imported by name only."""
from .batching import ContinuousBatcher, Request, SlotScheduler
from .fleet import FleetReport, GossipFleet
from .gossip_train import (GossipDraws, GossipTrainer, GossipTrainState,
                           PairRingDraws, StackedDraws, StackedGossipState,
                           StackedGossipTrainer, stack_workers,
                           unstack_workers)
from .mesh import (AbstractMesh, LocalMesh, RankMesh, make_gossip_mesh,
                   make_production_mesh, make_rank_mesh, make_replay_mesh,
                   mesh_devices, rules_for)
from .mesh_replay import MeshReplay

__all__ = ["ContinuousBatcher", "Request", "SlotScheduler", "FleetReport",
           "GossipFleet", "GossipDraws", "GossipTrainer", "GossipTrainState",
           "PairRingDraws", "StackedDraws", "StackedGossipState",
           "StackedGossipTrainer", "stack_workers",
           "unstack_workers", "AbstractMesh", "LocalMesh", "RankMesh",
           "make_gossip_mesh", "make_production_mesh", "make_rank_mesh",
           "make_replay_mesh", "mesh_devices", "rules_for", "MeshReplay"]
