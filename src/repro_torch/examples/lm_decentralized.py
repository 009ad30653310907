"""End to end on the port: decentralized training of nano-lm with 8
asynchronous gossip workers, the AD-PSGD baseline against A2CiD2 on the
ring.  The twin of the JAX package's ``examples/lm_decentralized.py``,
printing its lines.

Reduced-scale by default; ``--full`` takes nano-lm at its full width
(128,404,224 parameters).

    PYTHONPATH=src python -m repro_torch.examples.lm_decentralized \\
        --rounds 200 [--device cpu]

The first line's entropy rate (``bayes_ce``) is numpy on the host: at
the full vocabulary (32,000) it is 200 products of a vector with an
8.2 GB f64 matrix.  The weights (seed 0) and the token draws (the
replay's generator, seed 1) come from ``torch.Generator``s on the device,
so their values differ from the JAX example's; ``run`` takes the stream
and the weights from the caller, which is how a test holds it against
the JAX package on carried weights and a shared token table.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs import get_config
from ..core import Simulator, ring_graph
from ..core.simulator import SimState, SimTrace
from ..core.tree import tree_leaves
from ..data import LMTaskStream
from ..device import resolve_device
from ..models.transformer import Model, lm_grad_fn
from . import two_arms


class Arm(NamedTuple):
    state: SimState
    trace: SimTrace
    seconds: float
    line: str


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lm_decentralized")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def run(args: argparse.Namespace, stream=None, params0=None
        ) -> tuple[str, dict[str, Arm]]:
    """The header line and both arms on one schedule.  ``stream`` (default
    ``LMTaskStream(concentration=0.15)`` at the model's vocabulary) gives
    ``sample_workers`` to the gradient and ``bayes_ce`` to the header;
    ``params0`` the starting weights."""
    dev = resolve_device(args.device)
    cfg = get_config("nano-lm", reduced=not args.full)
    model = Model(cfg)
    if stream is None:
        stream = LMTaskStream(vocab_size=cfg.vocab_size,
                              seq_len=args.seq_len,
                              batch_size=args.batch_size,
                              concentration=0.15, device=dev)
    if params0 is None:
        params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    header = (f"nano-lm: {n_params / 1e6:.1f}M params, {args.workers} "
              f"workers, ring graph, bayes CE {stream.bayes_ce():.3f}")
    grad_fn = lm_grad_fn(model, stream)
    arms, sched = two_arms(ring_graph(args.workers), args.rounds, args.seed)
    out = {}
    for kind, world in arms.items():
        sim = Simulator(grad_fn, world.algorithm_params(), gamma=0.05,
                        device=dev)
        state = sim.init(params0, args.workers,
                         torch.Generator(device=dev).manual_seed(1))
        t0 = time.time()
        state, trace = sim.run_schedule(state, sched)
        loss0, tail = float(trace.loss[0]), float(trace.loss[-10:].mean())
        consensus = float(trace.consensus[-10:].mean())
        seconds = time.time() - t0
        tag = "A2CiD2  " if kind == "a2cid2" else "baseline"
        line = (f"{tag}: loss {loss0:.3f} -> {tail:.3f}   "
                f"consensus {consensus:.2e}   ({seconds:.0f}s)")
        out[kind] = Arm(state, trace, seconds, line)
    return header, out


def main(argv=None) -> tuple[str, dict[str, Arm]]:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    header, out = run(args)
    print(header, flush=True)
    for arm in out.values():
        print(arm.line, flush=True)
    return header, out


if __name__ == "__main__":
    main()
