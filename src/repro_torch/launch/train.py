"""Training launcher, ported from ``repro.launch.train``.

  # single-process decentralized simulation (the paper's replay), on the card
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim \
      --arch nano-lm --workers 8 --graph ring --acid --steps 200

  # the same on the CPU, at the reduced size
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim \
      --arch nano-lm --device cpu --steps 5

  # synchronous single-device training (AR-SGD semantics), checkpointed
  PYTHONPATH=src python -m repro_torch.launch.train --mode sync \
      --arch nano-lm --full --steps 100 --ckpt ckpt

``--ckpt DIR`` saves the stacked replicas ``state.x`` after ``--mode sim``
and the parameters after ``--mode sync`` (``checkpoint.save``, the JAX
package's msgpack format, the last 3 steps kept).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import torch

from ..checkpoint import save
from ..configs import get_config
from ..core import (Simulator, build_graph, make_schedule,
                    params_from_graph)
from ..core.simulator import SimState, SimTrace
from ..data import LMTaskStream
from ..device import resolve_device
from ..models.transformer import Model, lm_grad_fn
from ..optim import sgd
from .steps import TrainState, make_train_step


class SimRun(NamedTuple):
    model: Model
    stream: LMTaskStream
    state: SimState
    trace: SimTrace
    seconds: float   # the replay's wall time, card synchronised


class SyncRun(NamedTuple):
    model: Model
    stream: LMTaskStream
    state: TrainState
    losses: torch.Tensor   # (steps,) f32 on the device
    seconds: float         # the training loop's wall time, card synchronised


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
    if args.ckpt:
        save(args.ckpt, args.steps, state.x)
        print(f"  checkpoint -> {args.ckpt}")
    return SimRun(model, stream, state, trace, dt)


def run_sync(args, stream: LMTaskStream | None = None) -> SyncRun:
    """Synchronous single-device training (AR-SGD semantics): ``sgd()`` at
    lr ``args.lr``, one ``stream`` batch a step from a generator seeded
    ``args.seed + 1``.  ``stream`` replaces the one built from ``args``."""
    dev = resolve_device(args.device)
    cfg, model = build_model(args.arch, reduced=not args.full)
    if stream is None:
        stream = LMTaskStream(vocab_size=cfg.vocab_size,
                              seq_len=args.seq_len,
                              batch_size=args.batch_size, seed=args.seed,
                              device=dev)
    train_step, optimizer = make_train_step(model, sgd(), lr=args.lr,
                                            remat=False)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = TrainState(params, optimizer.init(params))
    del params
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = stream.sample(gen)
        state, metrics = train_step(state, batch)
        losses.append(metrics["loss"])
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"[train/sync] step {i:5d} loss "
                  f"{float(metrics['loss']):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    bayes = f", bayes-CE {stream.bayes_ce():.4f}" if args.bayes_ce else ""
    print(f"[train/sync] {args.steps} steps in {dt:.1f}s{bayes}")
    if args.ckpt:
        save(args.ckpt, args.steps, state.params)
        print(f"  checkpoint -> {args.ckpt}")
    return SyncRun(model, stream, state, torch.stack(losses), dt)


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
    (run_sim if args.mode == "sim" else run_sync)(args)


if __name__ == "__main__":
    main()
