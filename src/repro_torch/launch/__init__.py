"""Entry points: the gossip trainers, the LM prefill step and the training
launcher."""
from .gossip_train import (GossipDraws, GossipTrainer, GossipTrainState,
                           PairRingDraws, StackedDraws, StackedGossipState,
                           StackedGossipTrainer, stack_workers,
                           unstack_workers)

__all__ = ["GossipDraws", "GossipTrainer", "GossipTrainState",
           "PairRingDraws", "StackedDraws", "StackedGossipState",
           "StackedGossipTrainer", "stack_workers", "unstack_workers"]
