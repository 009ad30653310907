"""Readings of a MoE cell's planted faults, beside ``calibrate.py``'s:

    PYTHONPATH=src python3 -m perfbench.calibrate_moe --workload <cell> \\
        --control-seeds 7 8 9

For each seed, the reference with each fault its architecture's
reference plants (``FAULTS`` of ``reference/<arch>.py``: for ``mla_moe``
capacity dispatch at 1.25, which drops picks, and gates taken from the
biased scores) against the sound float32 reference, by the output check's
three numbers: upper readings that the cell's limits must fail.  One JSON
line a reading, then a summary line of each fault's least readings.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import check, harness, spec
from .reference import replay as ref_replay
from .streams import schedule as schedule_gen


def readings(bench: spec.Bench, name: str, seeds, device: torch.device,
             out=sys.stdout) -> dict:
    cell = harness.Cell(bench, name)
    faults = cell.reference.FAULTS
    t = cell.traffic
    dyn = ref_replay.prop36(*schedule_gen.graph_edges(t["graph"],
                                                      t["workers"]),
                            t["workers"], t["accelerated"])
    upper = {f: [] for f in faults}
    for seed in seeds:
        arrays = cell.schedule(seed, 0.0)
        stream = cell.stream_mod.Stream(cell.cfg, cell.wl, seed, device)
        sound = harness.reference(cell, seed, arrays, stream, device)
        for fault in faults:
            other = ref_replay.replay(
                cell.arch.init_params(cell.cfg, seed, device),
                schedule_gen.rounds_slice(arrays, 0, harness.CHECK_ROUNDS),
                dyn, cell.wl["step_size"],
                lambda p, b, f=fault: cell.reference.loss(p, cell.cfg, b, f),
                stream.batch)
            gaps, where = check.compare(other, sound)
            upper[fault].append(gaps)
            print(json.dumps({"cell": name, "seed": seed, "kind": fault,
                              **gaps, "where": where}), file=out, flush=True)
            del other
            harness.free(device)
    summary = {"cell": name, "kind": "summary",
               "upper": {f: {k: min(g[k] for g in v) for k in check.NAMES}
                         for f, v in upper.items() if v}}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate_moe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: calibrate_moe needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"perfbench: card {harness.card_line()}", file=sys.stderr)
    root = Path(__file__).resolve().parent.parent
    readings(spec.Bench(root), args.workload, args.control_seeds,
             torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
