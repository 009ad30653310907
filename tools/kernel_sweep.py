"""Time the ``mixing_gossip_stacked`` and ``rmsnorm_2d`` CUDA kernels
against edited copies of their own sources and, with ``--baseline``, an
earlier version of them, in one process on one card.

    python3 tools/kernel_sweep.py [--baseline KERNELS_DIR]

A variant is a copy of the kernel package's ``csrc/`` under
``build/sweep/``, with the text replacements that ``VARIANTS`` lists made
in its ``.cu`` (each text must occur exactly once), built by
``kernels/build.py`` with the port's flags; all builds start together.
``--baseline`` names the ``src/repro_torch/kernels`` directory of another
commit (unpacked with ``git archive``), whose two sources build unchanged
as the variant "baseline".  Each variant is held against the plain version
(the gossip kernel bit for bit, rmsnorm within 1e-5 at f32 and 2e-2 at
bf16) and timed with ``chip_smoke.py``'s ``cuda_ms`` and ``graph_ms``, in
the order v1 .. vn, then vn .. v1:

- ``mixing_gossip_stacked``: 10 back-to-back launches, at 16
  ResNet-18-CIFAR rows f32 with 4 idle rows (``chip_smoke.py`` phase 1's
  input) and with none, the same in bf16 with 4 idle, and 8 nano-lm rows
  f32 (the (A) replay's bank), beside PyTorch's ``copy_`` of the same
  bytes;
- ``rmsnorm_2d``: 20 and 200 back-to-back launches and 20 launches in a
  CUDA graph, at (8192, 768), (8192, 1024), (64, 8192) and (16, 16384), f32
  and bf16, beside ``F.rms_norm`` timed the same three ways.

Every variant launches through the same bare ctypes call (a fresh output,
the current stream), so eager times compare kernels, not wrappers.  Prints
one line a shape and variant, with the card's name and power limit, and
writes them to ``chiprun_out/kernel_sweep.json``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (it puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.a2cid2_mixing import kernel as gk  # noqa: E402
from repro_torch.kernels.a2cid2_mixing.ref import (  # noqa: E402
    dtype_scalar, mixing_gossip_stacked_ref)
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

GOSSIP, RMSNORM = "mixing_gossip_stacked", "rmsnorm_2d"
ARGTYPES = {GOSSIP: gk._ARGTYPES[GOSSIP], RMSNORM: rk._ARGTYPES}
_PREFETCH = "        if (next < rows) load_row(nv, next);\n"
_SHIFT = "        for (int k = 0; k < V; ++k) v[k] = nv[k];\n"
# kernel -> {label: ((text, replacement), ...)}
VARIANTS = {
    GOSSIP: {
        **{f"{u} vectors": (("return 16 / T::kLanes;", f"return {u};"),)
           for u in (1, 2, 4)},
        **{f"{b} blocks": (("kMaxBlocks = 16384;", f"kMaxBlocks = {b};"),)
           for b in (4096, 8192)},
    },
    # the next row loaded after this row's stores, not before its sum
    RMSNORM: {"no prefetch": ((_PREFETCH, ""),
                              (_SHIFT, "        if (next < rows) "
                                       "load_row(v, next);\n"))},
}
DYN = dict(eta=0.5, alpha=0.5, alpha_t=1.5)
RESNET_D, NANO_D = 11_171_328, 128_404_224
# (label, W, D, dtype, idle rows)
GOSSIP_SHAPES = (("resnet f32, 4 idle", 16, RESNET_D, torch.float32, 4),
                 ("resnet f32, 0 idle", 16, RESNET_D, torch.float32, 0),
                 ("resnet bf16, 4 idle", 16, RESNET_D, torch.bfloat16, 4),
                 ("nano-lm f32, 0 idle", 8, NANO_D, torch.float32, 0))
RMSNORM_SHAPES = ((8192, 768), (8192, 1024), (64, 8192), (16, 16384))


def variant_roots(name: str, baseline: Path | None) -> dict:
    """{label: the kernels tree to build ``name`` from}: the tree as it is,
    an edited copy a variant, and the baseline's."""
    src = build.source(name)
    roots = {"as is": src.parents[2]}
    for label, edits in VARIANTS[name].items():
        root = build.BUILD_DIR / "sweep" / name / label.replace(" ", "_")
        csrc = root / build.PACKAGES[name] / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(src.parent, csrc)
        text = src.read_text()
        for old, new in edits:
            cs.require(text.count(old) == 1,
                       f"{label}: {old!r} is not in {src.name} exactly once")
            text = text.replace(old, new)
        (csrc / src.name).write_text(text)
        roots[label] = root
    if baseline is not None:
        roots["baseline"] = baseline.resolve()
    return roots


def build_variants(roots: dict) -> dict:
    """{kernel: {label: its launch function}}, every library built at
    once."""
    jobs = [(name, label, root) for name, by_label in roots.items()
            for label, root in by_label.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(
            lambda job: build.build_all((job[0],), job[2])[job[0]][0], jobs))
    fns = {name: {} for name in roots}
    for (name, label, _), path in zip(jobs, paths):
        fns[name][label] = build.bind(path, name, ARGTYPES[name])
    return fns


def gossip_launch(fn, x, xt, partner, dt):
    out = torch.empty_like(x)
    err = fn(build.DTYPE_CODE[x.dtype], x.data_ptr(), xt.data_ptr(),
             out.data_ptr(), partner.data_ptr(), dt.data_ptr(), x.shape[0],
             x.shape[1], float(-2.0 * DYN["eta"]),
             dtype_scalar(DYN["alpha"], x.dtype),
             dtype_scalar(DYN["alpha_t"], x.dtype),
             torch.cuda.current_stream().cuda_stream)
    cs.require(err == 0, f"launch failed: CUDA error {err}")
    return out, xt


def rmsnorm_launch(fn, x, sc):
    out = torch.empty_like(x)
    err = fn(build.DTYPE_CODE[x.dtype], x.data_ptr(), sc.data_ptr(),
             out.data_ptr(), x.shape[0], x.shape[1], 1e-6,
             torch.cuda.current_stream().cuda_stream)
    cs.require(err == 0, f"launch failed: CUDA error {err}")
    return out


def both_ways(labels: list, time_one) -> dict:
    """{label: [time, time]}, timed in the order v1 .. vn, vn .. v1."""
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(time_one(label))
    return times


def sweep_gossip(card: str, fns: dict) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, w, d, dtype, idle in GOSSIP_SHAPES:
        x = torch.randn(w, d, generator=gen, device=dev).to(dtype)
        xt = torch.randn(w, d, generator=gen, device=dev).to(dtype)
        partner = torch.from_numpy(cs.involution(w, idle, seed=d)).to(dev)
        dt = torch.rand(w, generator=gen, device=dev) * 1.5
        rx, rxt = mixing_gossip_stacked_ref(x, xt, partner, dt, **DYN)
        exact = {}
        for label, fn in fns.items():
            kx, kxt = gossip_launch(fn, x, xt.clone(), partner, dt)
            torch.cuda.synchronize()
            exact[label] = bool(torch.equal(kx, rx) and torch.equal(kxt, rxt))
            del kx, kxt
        del rx, rxt
        xt_run = xt.clone()
        times = both_ways(list(fns), lambda label: cs.cuda_ms(
            lambda: gossip_launch(fns[label], x, xt_run, partner, dt),
            reps=10))
        nbytes = 4 * w * d * x.element_size() + 2 * w * 4
        bound_ms = nbytes / cs.PEAK_BYTES_PER_S * 1e3
        # x and x~ read, two buffers written: what a stream that reads as
        # much as it writes reaches on this card (not this function)
        src = torch.stack((x, xt_run))
        dst = torch.empty_like(src)
        copy_ms = cs.cuda_ms(lambda: dst.copy_(src), reps=10)
        del src, dst
        print(f"[{card}] {GOSSIP} {shape} ({w}, {d}): bound {bound_ms:.4f} "
              f"ms; torch copy_ of the same bytes {copy_ms:.4f} ms "
              f"({bound_ms / copy_ms:.1%} of the bound)")
        for label, ts in times.items():
            ms = float(np.mean(ts))
            rows.append({"card": card, "kernel": GOSSIP, "shape": shape,
                         "variant": label, "ms": ts, "bound_ms": bound_ms,
                         "copy_ms": copy_ms, "bit_exact": exact[label]})
            print(f"[{card}] {GOSSIP} {shape} {label}: "
                  f"{' / '.join(f'{t:.4f}' for t in ts)} ms "
                  f"({bound_ms / ms:.1%} of the bound), bit for bit the "
                  f"plain version: {exact[label]}")
        del x, xt, xt_run
        torch.cuda.empty_cache()
    return rows


def sweep_rmsnorm(card: str, fns: dict) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ways = {"eager 20": lambda f: cs.cuda_ms(f, reps=20),
            "eager 200": lambda f: cs.cuda_ms(f, reps=200),
            "graph 20 x 10": lambda f: cs.graph_ms(f, calls=20)[0]}
    rows = []
    for t, d in RMSNORM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
            sc = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            ref = rmsnorm_ref(x, sc).float()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            weight = 1 + sc
            calls = {label: (lambda fn=fn: rmsnorm_launch(fn, x, sc))
                     for label, fn in fns.items()}
            calls["F.rms_norm"] = lambda: F.rms_norm(x, (d,), weight, 1e-6)
            errs = {label: (call().float() - ref).abs().max().item()
                    for label, call in calls.items()}
            times = both_ways(list(calls), lambda label: {
                way: time(calls[label]) for way, time in ways.items()})
            bound_ms = (2 * t * d + d) * x.element_size() \
                / cs.PEAK_BYTES_PER_S * 1e3
            shape = f"({t}, {d}) {str(dtype)[6:]}"
            for label, ts in times.items():
                ms = {way: [m[way] for m in ts] for way in ways}
                rows.append({"card": card, "kernel": RMSNORM, "shape": shape,
                             "variant": label, "bound_ms": bound_ms,
                             "max_abs_err": errs[label],
                             "within_tol": (errs[label] <= tol
                                            if label in fns else None),
                             **ms})
                print(f"[{card}] {RMSNORM} {shape} {label}: "
                      + "; ".join(f"{way} {' / '.join(f'{v:.4f}' for v in vs)}"
                                  for way, vs in ms.items())
                      + f" ms (bound {bound_ms:.4f} ms); max abs err "
                        f"{errs[label]:.3e} (atol {tol:g})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another src/repro_torch/kernels directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    fns = build_variants({name: variant_roots(name, args.baseline)
                          for name in VARIANTS})
    rows = sweep_rmsnorm(card, fns[RMSNORM]) + sweep_gossip(card,
                                                            fns[GOSSIP])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_sweep.json").write_text(json.dumps(rows, indent=1))
    ok = all(r.get("bit_exact", r.get("within_tol")) is not False
             for r in rows)
    print(f"every variant agrees with the plain version: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
