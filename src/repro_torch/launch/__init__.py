"""Entry points: the gossip trainers, the LM train / prefill / serve steps,
the training launcher (``launch.train``) and the serving path: the
``generate`` CLI (``launch.serve``), continuous batching
(``launch.batching.ContinuousBatcher`` over a host ``SlotScheduler``) and
the gossip-serving fleet (``launch.fleet.GossipFleet``), and the sharded
worlds replay (``launch.mesh_replay.MeshReplay`` on a ``launch.mesh``
replay mesh).  ``launch.serve`` and ``launch.train`` are CLIs
(``python -m``), imported by name only."""
from .batching import ContinuousBatcher, Request, SlotScheduler
from .fleet import FleetReport, GossipFleet
from .gossip_train import (GossipDraws, GossipTrainer, GossipTrainState,
                           PairRingDraws, StackedDraws, StackedGossipState,
                           StackedGossipTrainer, stack_workers,
                           unstack_workers)
from .mesh import LocalMesh, RankMesh, make_rank_mesh, make_replay_mesh
from .mesh_replay import MeshReplay

__all__ = ["ContinuousBatcher", "Request", "SlotScheduler", "FleetReport",
           "GossipFleet", "GossipDraws", "GossipTrainer", "GossipTrainState",
           "PairRingDraws", "StackedDraws", "StackedGossipState",
           "StackedGossipTrainer", "stack_workers",
           "unstack_workers", "LocalMesh", "RankMesh", "make_rank_mesh",
           "make_replay_mesh", "MeshReplay"]
