"""Quickstart on the port: A2CiD2 on a heterogeneous quadratic over a
ring, accelerated against the baseline; the same world made hostile
(stragglers, churn, a mid-run topology switch) as a declarative ``World``;
a lossy ring (stale reads, drops, two Byzantine edges) with and without
the trim rule; the self-healing defense against a sign-flip attack the
static trim cannot see; and a sweep of worlds replayed in one
``run_worlds`` call.  The twin of the JAX package's
``examples/quickstart.py``, printing its lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Each section is a function of the targets ``b`` (its shape fixes the
workers and the dimension), the gradient noise, the rounds and the
device, and returns its printed lines with each arm's final state and
trace; ``engine=False`` replays its arms on the per-event path instead
of the kernels (the oracle a check holds the kernels' replay against).  ``b`` is drawn from a ``torch.Generator`` seeded 1 on the CPU, and
the noise from the replay's generator (seeded 2 on the device): their
values differ from the JAX example's ``jax.random`` draws, so the printed
numbers do too; a test holds each section against the JAX package on a
shared numpy ``b`` with the noise at 0.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import (AdaptiveDefense, ByzantineEdges, ChannelModel,
                    DelayProcess, PhaseSwitch, Simulator, WorkerModel, World,
                    WorldSweep, hypercube_graph, params_from_graph,
                    ring_graph, worker_mean)
from ..core.simulator import SimState, SimTrace
from ..device import resolve_device

N_WORKERS, DIM, ROUNDS = 16, 64, 300
NOISE, GAMMA = 0.05, 0.05


def draw_b(n: int = N_WORKERS, dim: int = DIM) -> torch.Tensor:
    """The workers' targets, (n, dim) f32 from a CPU generator seeded 1, so
    that the card and the CPU start from the same values."""
    return torch.randn((n, dim), generator=torch.Generator().manual_seed(1))


def quadratic_grad(target: torch.Tensor, noise: float):
    """Batched ``grad_fn`` of f_i(x) = ||x - b_i||² / 2: ``target`` is the
    (n, dim) ``b`` or one shared (dim,) target; the gradient carries
    ``noise`` times a normal draw from the replay's generator."""
    def grad_fn(x, generator, worker_ids):
        d = x - (target[worker_ids] if target.dim() == 2 else target)
        g = d
        if noise:
            g = d + noise * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype)
        return 0.5 * (d ** 2).sum(1), g
    return grad_fn


class Run(NamedTuple):
    """One arm: its final state, its trace, and the extra number of its
    printed line (distance to the optimum, rejected exchanges)."""
    state: SimState
    trace: SimTrace
    number: float | None = None


@dataclasses.dataclass
class Section:
    lines: list[str]
    runs: dict[str, Run]


def _start(sim: Simulator, n: int, dim: int) -> SimState:
    return sim.init(torch.zeros(dim, device=sim.device), n,
                    torch.Generator(device=sim.device).manual_seed(2))


def _setup(b, device):
    dev = resolve_device(device)
    b = b.to(dev)
    return dev, b, ring_graph(b.shape[0])


def calm_ring(b, noise=NOISE, rounds=ROUNDS, device="cuda",
              engine=True) -> Section:
    """The ring, baseline and A2CiD2, with its chi1 and chi2."""
    dev, b, graph = _setup(b, device)
    n, dim = b.shape
    c1, c2 = graph.chi1(), graph.chi2()
    lines = [f"ring graph: chi1={c1:.1f} chi2={c2:.2f} (A2CiD2 accelerates "
             f"chi1 -> sqrt(chi1*chi2)={(c1 * c2) ** 0.5:.1f})"]
    runs = {}
    for accelerated in (False, True):
        sim = Simulator(quadratic_grad(b, noise),
                        params_from_graph(graph, accelerated=accelerated),
                        gamma=GAMMA, device=dev)
        state, trace = sim.run_world(_start(sim, n, dim),
                                     World(topology=graph), rounds, seed=0,
                                     engine=engine)
        err = float(((worker_mean(state.x) - b.mean(0)) ** 2).sum())
        name = "A2CiD2  " if accelerated else "baseline"
        runs[name.strip()] = Run(state, trace, err)
        lines.append(f"{name}: consensus distance "
                     f"{float(trace.consensus[-1]):.3f}  "
                     f"distance to optimum {err:.2e}")
    return Section(lines, runs)


def hostile_world(n: int, rounds: int) -> World:
    """Odd workers at 1/4 gradient rate, workers 0 and 1 detached from
    rounds // 3, and a hypercube (n a power of two) from 2 * (rounds // 3)
    with every worker back."""
    k = n.bit_length() - 1
    if n < 2 or 1 << k != n:
        raise ValueError(f"the hostile world's hypercube needs a power of "
                         f"two workers, got {n}")
    graph = ring_graph(n)
    stragglers = np.where(np.arange(n) % 2 == 0, 1.0, 0.25)
    active = np.ones(n, bool)
    active[:2] = False
    return World(topology=graph,
                 workers=WorkerModel(grad_rates=stragglers),
                 faults=(PhaseSwitch(rounds // 3, active=tuple(active)),
                         PhaseSwitch(2 * (rounds // 3),
                                     topology=hypercube_graph(k))))


def hostile(b, noise=NOISE, rounds=ROUNDS, device="cuda",
            engine=True) -> Section:
    """The hostile world compiled once, replayed by both arms through
    ``run_schedule``, with the per-phase chi1."""
    dev, b, graph = _setup(b, device)
    n, dim = b.shape
    world = hostile_world(n, rounds)
    sched = world.compile(rounds, seed=0)
    chis = ", ".join(f"{c1:.1f}"
                     for c1, _ in world.phase_plan(rounds).phase_chis())
    lines = ["\nheterogeneous world: stragglers + churn + ring->hypercube "
             "switch"]
    runs = {}
    for accelerated in (False, True):
        sim = Simulator(quadratic_grad(b, noise),
                        params_from_graph(graph, accelerated=accelerated),
                        gamma=GAMMA, device=dev)
        state, trace = sim.run_schedule(_start(sim, n, dim), sched,
                                        engine=engine)
        name = "A2CiD2  " if accelerated else "baseline"
        runs[name.strip()] = Run(state, trace)
        lines.append(f"{name}: consensus distance "
                     f"{float(trace.consensus[-1]):.3f}  "
                     f"(per-phase chi1: {chis})")
    return Section(lines, runs)


def byzantine_edges(graph):
    """The two attacked edges: the ring's first and the one opposite."""
    return (graph.edges[0], graph.edges[graph.n // 2])


def lossy_world(graph) -> World:
    """Stale reads (up to 3 rounds), 2% drops and two edges scaling half
    their exchanges by 1e3."""
    return World(topology=graph, channel=ChannelModel(
        delay=DelayProcess(horizon=3, prob=0.5),
        adversary=ByzantineEdges(byzantine_edges(graph), mode="scale",
                                 scale=1e3, prob=0.5),
        drop_prob=0.02))


def lossy(b, noise=NOISE, rounds=ROUNDS, device="cuda",
          engine=True) -> Section:
    """The lossy world, A2CiD2 with and without the trim at tau 5."""
    dev, b, graph = _setup(b, device)
    n, dim = b.shape
    world = lossy_world(graph)
    lines = ["\nlossy ring: stale reads + drops + 2 Byzantine edges"]
    runs = {}
    for robust in (False, True):
        sim = Simulator(quadratic_grad(b, noise),
                        params_from_graph(graph, accelerated=True),
                        gamma=GAMMA, robust_clip=5.0 if robust else None,
                        robust_rule="trim", device=dev)
        state, trace = sim.run_world(_start(sim, n, dim), world, rounds,
                                     seed=0, engine=engine)
        tail = float(trace.consensus[-1])
        name = "A2CiD2 + trim   " if robust else "A2CiD2 no defense"
        runs[name.strip()] = Run(state, trace)
        shown = "DIVERGED" if not np.isfinite(tail) else f"{tail:.3f}"
        lines.append(f"{name}: consensus distance {shown}")
    return Section(lines, runs)


def sign_flip_world(graph, defense) -> World:
    return World(topology=graph, defense=defense, channel=ChannelModel(
        adversary=ByzantineEdges(byzantine_edges(graph), mode="sign_flip",
                                 prob=1.0)))


def self_healing(b, noise=NOISE, rounds=ROUNDS, device="cuda",
                 engine=True) -> Section:
    """A shared target 0.2 b_0, so that a flipped exchange (norm about 3)
    stays under tau = 5: the static trim never fires, and its replay is
    bit for bit the undefended one; the adaptive defense tightens tau and
    quarantines the two edges."""
    dev, b, graph = _setup(b, device)
    n, dim = b.shape
    lines = ["\nself-healing: sign-flip attack at honest scale, adaptive "
             "tau"]
    runs = {}
    for label, defense in (("static trim    ", None),
                           ("adaptive defense", AdaptiveDefense())):
        sim = Simulator(quadratic_grad(0.2 * b[0], noise),
                        params_from_graph(graph, accelerated=True),
                        gamma=GAMMA, robust_clip=5.0, robust_rule="trim",
                        device=dev)
        state, trace = sim.run_world(_start(sim, n, dim),
                                     sign_flip_world(graph, defense),
                                     rounds, seed=0, engine=engine)
        rej = float(trace.defense.rejections.sum()) if trace.defense \
            else 0.0
        runs[label.strip()] = Run(state, trace, rej)
        lines.append(f"{label}: consensus distance "
                     f"{float(trace.consensus[-1]):.4f}  "
                     f"(rejected exchanges: {rej:.0f})")
    return Section(lines, runs)


def sweep_worlds(n: int) -> WorldSweep:
    return WorldSweep.over(World(topology=ring_graph(n)), seeds=(0, 1),
                           comms_per_grad=[0.5, 1.0, 2.0])


def sweep(b, noise=NOISE, rounds=ROUNDS, device="cuda",
          engine=True) -> Section:
    """comms_per_grad {0.5, 1, 2} x seeds {0, 1}: six worlds in one
    ``run_worlds`` call (``runs["sweep"]`` holds the batched state and the
    (6, rounds) trace)."""
    dev, b, graph = _setup(b, device)
    n, dim = b.shape
    grid = sweep_worlds(n)
    sim = Simulator(quadratic_grad(b, noise),
                    params_from_graph(graph, accelerated=True),
                    gamma=GAMMA, device=dev)
    states = [_start(sim, n, dim) for _ in range(grid.size)]
    final, traces = sim.run_worlds(states, grid.compile(rounds),
                                   engine=engine)
    lines = ["\nbatched sweep: comms_per_grad grid x 2 seeds, one compiled "
             "scan"]
    for i, (w, s) in enumerate(grid.points()):
        lines.append(f"comms/grad={w.comms_per_grad:<4} seed={s}: "
                     f"consensus distance "
                     f"{float(traces.consensus[i, -1]):.3f}")
    return Section(lines, {"sweep": Run(final, traces)})


SECTIONS = {"calm": calm_ring, "hostile": hostile, "lossy": lossy,
            "self_healing": self_healing, "sweep": sweep}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def print_section(section: Section) -> Section:
    for line in section.lines:
        print(line, flush=True)
    return section


def main(argv=None) -> dict[str, Section]:
    """Every section in turn at the example's sizes and noise, printing
    its lines; returns the sections by name."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    b = draw_b()
    return {name: print_section(section(b, NOISE, args.rounds, dev))
            for name, section in SECTIONS.items()}


if __name__ == "__main__":
    main()
