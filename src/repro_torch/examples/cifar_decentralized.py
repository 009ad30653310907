"""The paper's own experiment family at small scale, on the port: ResNet-8
on CIFAR-like data with asynchronous decentralized workers (paper Sec 4,
Tab 4), the AD-PSGD baseline against A2CiD2.  The twin of the JAX
package's ``examples/cifar_decentralized.py``, printing its lines.

    PYTHONPATH=src python -m repro_torch.examples.cifar_decentralized \\
        --rounds 60 [--device cpu]

The weights (seed 0), the workers' batches (the replay's generator, seed
1) and the held-out batch (seed 123) come from ``torch.Generator``s on the
device, so their values differ from the JAX example's; ``run`` takes the
stream and the weights from the caller, which is how a test holds it
against the JAX package on carried weights and a shared batch table.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..core import Simulator, build_graph, worker_mean
from ..core.simulator import SimState, SimTrace
from ..data import SyntheticCIFAR
from ..device import resolve_device
from ..models.resnet import (init_resnet, resnet8_cifar, resnet_grad_fn,
                             resnet_loss)
from . import two_arms


class Arm(NamedTuple):
    state: SimState
    trace: SimTrace
    test_acc: float
    seconds: float
    line: str


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.cifar_decentralized")
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--graph", default="ring")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def run(args: argparse.Namespace, stream=None, params0=None,
        engine: bool = True) -> dict[str, Arm]:
    """Both arms on one schedule.  ``stream`` (default ``SyntheticCIFAR(
    batch_size, noise=0.5)``) gives ``sample_workers`` to the gradient and
    ``sample`` the held-out batch; ``params0`` the starting weights;
    ``engine=False`` replays on the per-event path instead of the
    kernels."""
    dev = resolve_device(args.device)
    cfg = resnet8_cifar()
    if stream is None:
        stream = SyntheticCIFAR(batch_size=args.batch_size, noise=0.5,
                                device=dev)
    if params0 is None:
        params0 = init_resnet(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    grad_fn = resnet_grad_fn(cfg, stream)
    graph = build_graph(args.graph, args.workers)
    arms, sched = two_arms(graph, args.rounds, args.seed)
    out = {}
    for kind, world in arms.items():
        sim = Simulator(grad_fn, world.algorithm_params(), gamma=0.05,
                        device=dev)
        state = sim.init(params0, args.workers,
                         torch.Generator(device=dev).manual_seed(1))
        t0 = time.time()
        state, trace = sim.run_schedule(state, sched, engine=engine)
        # evaluate the consensus model
        test = stream.sample(torch.Generator(device=dev).manual_seed(123))
        with torch.no_grad():
            _, metrics = resnet_loss(worker_mean(state.x), cfg, test)
        acc = float(metrics["acc"])
        seconds = time.time() - t0
        tag = "A2CiD2  " if kind == "a2cid2" else "baseline"
        line = (f"{tag} ({args.graph}): loss {float(trace.loss[0]):.3f} -> "
                f"{float(trace.loss[-5:].mean()):.3f}  test acc {acc:.2f}  "
                f"({seconds:.0f}s)")
        out[kind] = Arm(state, trace, acc, seconds, line)
    return out


def main(argv=None) -> dict[str, Arm]:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    out = run(args)
    for arm in out.values():
        print(arm.line, flush=True)
    return out


if __name__ == "__main__":
    main()
