"""The JAX package's four examples (``examples/*.py``) on the port.

Each module runs as ``python -m repro_torch.examples.<name>`` on the card
(``--device cpu`` names the CPU) and prints the JAX example's lines in
its format: ``quickstart`` (the quadratic on a ring: calm, hostile,
lossy, self-healing, and a sweep), ``cifar_decentralized`` (ResNet-8 on
``SyntheticCIFAR``), ``lm_decentralized`` (nano-lm on ``LMTaskStream``)
and ``serve_lm`` (a gossip-serving fleet).  Importing a module runs
nothing: the work is under ``main()``, and each exposes its runs as
functions with the seams that a parity test needs (the data, the
weights, the noise).
"""
from __future__ import annotations

from ..core import Algorithm, World


def two_arms(graph, rounds: int, seed: int):
    """The CIFAR and LM examples' AD-PSGD and A2CiD2 worlds and the one
    schedule they share (both are coupled-clock algorithms, so they
    compile the same one)."""
    arms = {"adpsgd": World(topology=graph, algorithm=Algorithm("adpsgd")),
            "a2cid2": World(topology=graph, algorithm=Algorithm("a2cid2"))}
    return arms, arms["a2cid2"].compile(rounds, seed=seed)
