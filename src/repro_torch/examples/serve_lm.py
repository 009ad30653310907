"""A gossip-serving fleet on the port: 8 decode replicas of reduced nano-lm
on a lossy ring that never stop averaging, surviving a mid-serve churn
kill.  The twin of the JAX package's ``examples/serve_lm.py``, printing
its lines.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The weights (seed 0) and the "perturb" drift come from
``torch.Generator``s on the device, so their values differ from the JAX
example's; the request trace is ``ServeLoad``'s numpy draw, the JAX
package's.  ``run`` takes the weights and a drift ``grad_fn`` from the
caller, which is how a test holds it against the JAX package's fleet.
"""
from __future__ import annotations

import argparse

import torch

from ..configs.nano_lm import reduced
from ..core import (Algorithm, ChannelModel, DelayProcess, PhaseSwitch,
                    ServeLoad, World, ring_graph)
from ..device import resolve_device
from ..launch.fleet import FleetReport, GossipFleet
from ..models.transformer import Model

REPLICAS, KILL_ROUND = 8, 20
FLEET_KW = dict(max_batch=4, max_len=24, drift_scale=0.02)


def make_world() -> World:
    """8 replicas on a ring with stale (horizon 2, prob 0.3) and lossy (10%
    drops) links; the last replica killed at round 20."""
    return World(
        topology=ring_graph(REPLICAS),
        algorithm=Algorithm("a2cid2"),
        channel=ChannelModel(delay=DelayProcess(horizon=2, prob=0.3),
                             drop_prob=0.1),
        faults=(PhaseSwitch(KILL_ROUND,
                            active=(True,) * (REPLICAS - 1) + (False,)),),
        serve=ServeLoad(rate=1.0, prompt_len=(3, 6), gen_len=(4, 10)),
    )


def run(device="cuda", rounds: int = 60, seed: int = 0, params=None,
        grad_fn=None) -> FleetReport:
    """The fleet on the device: ``params`` (default ``Model.init`` from
    seed 0) and, in place of the Gaussian drift, an optional ``grad_fn``
    (the port's batched ``Simulator`` signature) at rate 0.02."""
    dev = resolve_device(device)
    model = Model(reduced())
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    drift = dict(grad_fn=grad_fn) if grad_fn is not None \
        else dict(drift="perturb")
    fleet = GossipFleet(model, params, make_world(), **FLEET_KW, **drift)
    return fleet.run(rounds=rounds, seed=seed)


def report_lines(rep: FleetReport) -> list[str]:
    s = rep.summary()
    return [f"fleet: {s['completed']}/{s['requests_total']} requests, "
            f"{s['tokens_per_second']:.0f} tok/s, p95 latency "
            f"{s['latency_p95']:.1f} rounds, consensus distance "
            f"{s['consensus_final']:.2f}",
            f"churn recovery: replica killed at round {KILL_ROUND} — lost "
            f"{s['lost']}, re-admitted {s['restarted']} in-flight requests "
            f"to survivors"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def main(argv=None) -> FleetReport:
    args = build_parser().parse_args(argv)
    rep = run(args.device, args.rounds, args.seed)
    for line in report_lines(rep):
        print(line, flush=True)
    return rep


if __name__ == "__main__":
    main()
