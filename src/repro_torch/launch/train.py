"""Training launcher, ported from ``repro.launch.train``.

  # single-process decentralized simulation (the paper's replay), on the card
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim \
      --arch nano-lm --workers 8 --graph ring --acid --steps 200

  # the same on the CPU, at the reduced size
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim \
      --arch nano-lm --device cpu --steps 5

``--mode sync`` (it needs ``launch/steps.make_train_step``) and ``--ckpt``
(it needs ``checkpoint/``) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import torch

from ..configs import get_config
from ..core import (Simulator, build_graph, make_schedule,
                    params_from_graph)
from ..core.simulator import SimState, SimTrace
from ..data import LMTaskStream
from ..device import resolve_device
from ..models.transformer import Model, lm_grad_fn


class SimRun(NamedTuple):
    model: Model
    stream: LMTaskStream
    state: SimState
    trace: SimTrace
    seconds: float   # the replay's wall time, card synchronised


def build_model(arch: str, reduced: bool):
    cfg = get_config(arch, reduced=reduced)
    return cfg, Model(cfg)


def run_sim(args, stream: LMTaskStream | None = None) -> SimRun:
    """Decentralized asynchronous training via the event simulator.

    ``stream`` replaces the ``LMTaskStream`` built from ``args`` (a caller
    that runs several arms passes one, so its transition logits are drawn
    once)."""
    dev = resolve_device(args.device)
    cfg, model = build_model(args.arch, reduced=not args.full)
    if stream is None:
        stream = LMTaskStream(vocab_size=cfg.vocab_size,
                              seq_len=args.seq_len,
                              batch_size=args.batch_size, seed=args.seed,
                              device=dev)
    graph = build_graph(args.graph, args.workers)
    acid = params_from_graph(graph, accelerated=args.acid)
    sim = Simulator(lm_grad_fn(model, stream), acid, gamma=args.lr,
                    device=dev)
    params0 = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = sim.init(params0, args.workers,
                     torch.Generator(device=dev).manual_seed(args.seed + 1))
    del params0
    sched = make_schedule(graph, rounds=args.steps,
                          comms_per_grad=args.comms_per_grad, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, trace = sim.run_schedule(state, sched)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[train/sim] {args.workers} workers, {args.graph} graph, "
          f"acid={args.acid}: {args.steps} rounds in {dt:.1f}s")
    bayes = f"  bayes-CE {stream.bayes_ce():.4f}" if args.bayes_ce else ""
    print(f"  final loss {float(trace.loss[-1]):.4f}  "
          f"consensus {float(trace.consensus[-1]):.3e}{bayes}")
    return SimRun(model, stream, state, trace, dt)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "sync"), default="sim")
    ap.add_argument("--arch", default="nano-lm")
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--graph", default="ring",
                    choices=("ring", "complete", "exponential", "star",
                             "torus"))
    ap.add_argument("--acid", action="store_true",
                    help="enable the A2CiD2 continuous momentum")
    ap.add_argument("--comms-per-grad", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--no-bayes-ce", dest="bayes_ce", action="store_false",
                    help="skip the Bayes CE: its numpy power iteration over "
                         "the (V, V) chain takes many minutes at V = 32000")
    return ap


def main(argv: Any = None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "sync":
        raise NotImplementedError("--mode sync needs launch/steps."
                                  "make_train_step, which is not ported to "
                                  "PyTorch yet")
    if args.ckpt:
        raise NotImplementedError("--ckpt needs checkpoint/, which is not "
                                  "ported to PyTorch yet")
    run_sim(args)


if __name__ == "__main__":
    main()
