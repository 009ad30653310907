"""Readings that the output check's limits are set from, on the card:

    PYTHONPATH=src python3 -m perfbench.calibrate --workload <cell> \\
        --seeds 1 2 ... --control-seeds 7 8 9

For each of ``--seeds``: the program's three check rounds at the cell's
size against the reference (a sound run's numbers: the lower readings).
For each of ``--control-seeds``: the reference with its products on the
TF32 tensor cores (the control, one precision below the configuration's
float32), and the reference with a planted fault (``half_batch``,
``no_exchange``), each against the float32 reference (the upper
readings; a step that leaves the state unchanged reads 1 by the
change_gap's measure and needs no run).  One set-up for every seed; one
JSON line a reading, then a summary line.  The benchmark's runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, harness, spec

FAULTS = ("half_batch", "no_exchange")


def readings(bench: spec.Bench, name: str, seeds, control_seeds,
             device: torch.device, out=sys.stdout) -> dict:
    cell = harness.Cell(bench, name)
    sound, upper = [], {k: [] for k in ("tf32",) + FAULTS}
    for seed in seeds:
        t0 = time.perf_counter()
        run = harness.build(cell, seed, 0.0, device)
        run.sim = run.state = None
        harness.free(device)
        ref = harness.reference(cell, seed, run.arrays, run.stream, device)
        gaps, where = check.compare(run.prog, ref)
        sound.append(gaps)
        print(json.dumps({"cell": name, "seed": seed, "kind": "program",
                          "seconds": time.perf_counter() - t0, **gaps,
                          "where": where}),
              file=out, flush=True)
        del run, ref
        harness.free(device)
    for seed in control_seeds:
        arrays = cell.schedule(seed, 0.0)
        stream = cell.stream_mod.Stream(cell.cfg, cell.wl, seed, device)
        ref = harness.reference(cell, seed, arrays, stream, device)
        for kind in upper:
            other = harness.reference(
                cell, seed, arrays, stream, device,
                prec="tf32" if kind == "tf32" else "f32",
                fault=None if kind == "tf32" else kind)
            gaps, where = check.compare(other, ref)
            upper[kind].append(gaps)
            print(json.dumps({"cell": name, "seed": seed, "kind": kind,
                              **gaps, "where": where}), file=out,
                  flush=True)
            del other
            harness.free(device)
    summary = {"cell": name, "kind": "summary",
               "lower": {k: max(g[k] for g in sound) for k in check.NAMES}
               if sound else None,
               "upper": {kind: {k: min(g[k] for g in v) for k in check.NAMES}
                         for kind, v in upper.items() if v}}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"perfbench: card {harness.card_line()}", file=sys.stderr)
    root = Path(__file__).resolve().parent.parent
    readings(spec.Bench(root), args.workload, args.seeds, args.control_seeds,
             torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
