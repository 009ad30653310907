"""Time the ``mixing_gossip_stacked``, ``rmsnorm_2d``, ``mixing_p2p`` and
``flash_attention_bhsd`` CUDA kernels against edited copies of their own
sources and, with ``--baseline``, an earlier version of them, in one
process on one card.

    python3 tools/kernel_sweep.py [--baseline KERNELS_DIR] [--only NAME ...]

A variant is a copy of the kernel package's ``csrc/`` under
``build/sweep/``, with the text replacements that ``VARIANTS`` lists made
in its ``.cu`` (each text must occur exactly once), built by
``kernels/build.py`` with the port's flags; all builds start together.
``--baseline`` names the ``src/repro_torch/kernels`` directory of another
commit (unpacked with ``git archive``), whose sources build unchanged
as the variant "baseline"; ``--only`` names the kernels to sweep (all four
by default).  Each variant is held against the plain version
(the gossip kernel bit for bit, rmsnorm within 1e-5 at f32 and 2e-2 at
bf16, flash at ``chip_smoke.py`` phase 11's gates) and timed with
``chip_smoke.py``'s ``cuda_ms`` and ``graph_ms``, in
the order v1 .. vn, then vn .. v1:

- ``mixing_gossip_stacked``: 10 back-to-back launches, at 16
  ResNet-18-CIFAR rows f32 with 4 idle rows (``chip_smoke.py`` phase 1's
  input) and with none, the same in bf16 with 4 idle, and 8 nano-lm rows
  f32 (the (A) replay's bank), beside PyTorch's ``copy_`` of the same
  bytes;
- ``rmsnorm_2d``: 20 and 200 back-to-back launches and 20 launches in a
  CUDA graph, at (8192, 768), (8192, 1024), (64, 8192) and (16, 16384), f32
  and bf16, beside ``F.rms_norm`` timed the same three ways;
- ``mixing_p2p``: the 56 leaves of a ResNet-18-CIFAR tree, f32 and bf16,
  20 trees back to back and 10 trees in a CUDA graph, and the largest leaf
  alone (20 launches in a graph), beside ``copy_`` of the tree's bytes.  A
  variant with the launch table (``kMaxSegments`` in its source) takes the
  tree in one launch, planned once by ``kernel.plan_launches`` with its own
  ``kChunk``; a baseline without one (the per-leaf kernel) takes 56 launches
  of its 12-argument entry point;
- ``flash_attention_bhsd``: RecurrentGemma-9B's local attention, (16,
  2048, 256) causal with a window of 2048, f32 and bf16, 20 launches back
  to back, beside ``scaled_dot_product_attention``; the variants change
  the bf16 hd 256 instantiation's stages and consumer warpgroups.

Every variant launches through the same bare ctypes call (a fresh output,
the current stream), so eager times compare kernels, not wrappers.  Prints
one line a shape and variant, with the card's name and power limit, and
writes them to ``chiprun_out/kernel_sweep.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
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
    dtype_scalar, mixing_gossip_stacked_ref, mixing_p2p_ref)
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, attention_ref)
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

GOSSIP, RMSNORM, P2P = "mixing_gossip_stacked", "rmsnorm_2d", "mixing_p2p"
FLASH = "flash_attention_bhsd"
ARGTYPES = {GOSSIP: gk._ARGTYPES[GOSSIP], RMSNORM: rk._ARGTYPES,
            P2P: gk._ARGTYPES[P2P], FLASH: fk._ARGTYPES}
_P, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)
# the per-leaf mixing_p2p_launch, before the launch table: dtype, x,
# x_tilde, xp, out_x, out_xt, dt, n, neg2eta, alpha, alpha_t, stream
PER_LEAF_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _LL, _F, _F, _F, _P)
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
    P2P: {
        **{f"chunk {c}": (("kChunk = 4096;", f"kChunk = {c};"),)
           for c in (2048, 8192)},
        **{f"{v} values": (("kValues = 16;", f"kValues = {v};"),)
           for v in (4, 8)},
    },
    # <dtype, hd, k tile, stages, consumer warpgroups> of bf16 hd 256 (one
    # warpgroup and 3 stages as is): 2 warpgroups beside the producer warp
    # are budgeted as 384 threads, 168 registers a thread, and the
    # accumulator spills
    FLASH: {
        "bf16 2 warpgroups, 2 stages": (
            ("launch<bf16, 256, 64, 3, 1>", "launch<bf16, 256, 64, 2, 2>"),),
        "bf16 1 warpgroup, 2 stages": (
            ("launch<bf16, 256, 64, 3, 1>", "launch<bf16, 256, 64, 2, 1>"),),
    },
}
DYN = dict(eta=0.5, alpha=0.5, alpha_t=1.5)
RESNET_D, NANO_D = 11_171_328, 128_404_224
# (label, W, D, dtype, idle rows)
GOSSIP_SHAPES = (("resnet f32, 4 idle", 16, RESNET_D, torch.float32, 4),
                 ("resnet f32, 0 idle", 16, RESNET_D, torch.float32, 0),
                 ("resnet bf16, 4 idle", 16, RESNET_D, torch.bfloat16, 4),
                 ("nano-lm f32, 0 idle", 8, NANO_D, torch.float32, 0))
RMSNORM_SHAPES = ((8192, 768), (8192, 1024), (64, 8192), (16, 16384))
# (BH, S, hd, window): RecurrentGemma-9B's local attention, causal
FLASH_SHAPE = (16, 2048, 256, 2048)


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


def per_leaf(name: str, root: Path) -> bool:
    """True for a mixing_p2p source from before the launch table."""
    return name == P2P and "kMaxSegments" not in \
        build.source(name, root).read_text()


def build_variants(roots: dict) -> dict:
    """{kernel: {label: its launch function}}, every library built at
    once."""
    jobs = [(name, label, root) for name, by_label in roots.items()
            for label, root in by_label.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(
            lambda job: build.build_all((job[0],), job[2])[job[0]][0], jobs))
    fns = {name: {} for name in roots}
    for (name, label, root), path in zip(jobs, paths):
        types = PER_LEAF_ARGTYPES if per_leaf(name, root) else ARGTYPES[name]
        fn = build.bind(path, name, types)
        if name == P2P:
            text = build.source(name, root).read_text()
            fn.chunk = (None if per_leaf(name, root) else
                        int(re.search(r"kChunk = (\d+);", text).group(1)))
        fns[name][label] = fn
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


def p2p_launcher(fn, xs, xts, xps, dt):
    """A bare launch of a tree (one launch a table, or one a leaf for the
    per-leaf kernel) into outputs made once: returns (the call, the output
    lists)."""
    dtype = xs[0].dtype
    size = xs[0].element_size()
    code = build.DTYPE_CODE[dtype]
    dyn = (float(-2.0 * DYN["eta"]), dtype_scalar(DYN["alpha"], dtype),
           dtype_scalar(DYN["alpha_t"], dtype))
    if fn.chunk is None:
        ox = [torch.empty_like(x) for x in xs]
        oxt = [torch.empty_like(x) for x in xs]
        args = [(x.data_ptr(), t.data_ptr(), p.data_ptr(), a.data_ptr(),
                 b.data_ptr(), x.numel())
                for x, t, p, a, b in zip(xs, xts, xps, ox, oxt)]

        def call():
            for x, t, p, a, b, n in args:
                cs.require(fn(code, x, t, p, a, b, dt.data_ptr(), n, *dyn,
                              torch.cuda.current_stream().cuda_stream) == 0,
                           "launch failed")
        return call, (ox, oxt)
    offsets, total = gk.out_offsets([x.data_ptr() for x in xs],
                                    [x.numel() for x in xs], size)
    bx = torch.empty(total, dtype=dtype, device=xs[0].device)
    bxt = torch.empty_like(bx)
    ox = [bx.as_strided(x.shape, x.stride(), o) for x, o in zip(xs, offsets)]
    oxt = [bxt.as_strided(x.shape, x.stride(), o)
           for x, o in zip(xs, offsets)]
    rows = [(x.data_ptr(), t.data_ptr(), p.data_ptr(), a.data_ptr(),
             b.data_ptr(), x.numel())
            for x, t, p, a, b in zip(xs, xts, xps, ox, oxt) if x.numel()]
    launches = gk.plan_launches(rows, size, chunk=fn.chunk)

    def call():
        for table, blocks in launches:
            cs.require(fn(code, table.ctypes.data, len(table), blocks,
                          fn.chunk, dt.data_ptr(), *dyn,
                          torch.cuda.current_stream().cuda_stream) == 0,
                       "launch failed")
    return call, (ox, oxt)


def sweep_p2p(card: str, fns: dict) -> list:
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.resnet import init_resnet, resnet18_cifar
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = tree_leaves(init_resnet(gen, resnet18_cifar()))
    big = max(range(len(x0)), key=lambda i: x0[i].numel())
    dt = torch.tensor(0.37, device=dev)
    ways = {"eager 20": lambda f: cs.cuda_ms(f, reps=20),
            "graph 10 x 10": lambda f: cs.graph_ms(f, calls=10)[0]}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        xs = [a.to(dtype) for a in x0]
        xts, xps = ([(a + 0.1 * torch.randn(a.shape, generator=gen,
                                            device=dev)).to(dtype)
                     for a in x0] for _ in range(2))
        refs = [mixing_p2p_ref(*leaf, dt, **DYN)
                for leaf in zip(xs, xts, xps)]
        n = sum(a.numel() for a in xs)
        for shape, idx in ((f"resnet tree {str(dtype)[6:]}", None),
                           (f"largest leaf {str(dtype)[6:]}", big)):
            pick = (lambda ls: ls) if idx is None else (lambda ls: [ls[idx]])
            # each call writes into its outputs: keep them all alive
            calls, exact, keep = {}, {}, []
            for label, fn in fns.items():
                call, (ox, oxt) = p2p_launcher(fn, pick(xs), pick(xts),
                                               pick(xps), dt)
                keep.append((ox, oxt))
                call()
                torch.cuda.synchronize()
                exact[label] = all(
                    torch.equal(a, r[0]) and torch.equal(b, r[1])
                    for a, b, r in zip(ox, oxt, pick(refs)))
                calls[label] = call
            m = n if idx is None else xs[idx].numel()
            nbytes = 5 * m * xs[0].element_size() + 4
            bound_ms = nbytes / cs.PEAK_BYTES_PER_S * 1e3
            src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
            dst = torch.empty_like(src)
            calls["copy_"] = lambda: dst.copy_(src)
            times = both_ways(list(calls), lambda label: {
                way: time(calls[label]) for way, time in ways.items()})
            for label, ts in times.items():
                ms = {way: [t[way] for t in ts] for way in ways}
                rows.append({"card": card, "kernel": P2P, "shape": shape,
                             "variant": label, "bound_ms": bound_ms,
                             "bit_exact": exact.get(label), **ms})
                print(f"[{card}] {P2P} {shape} {label}: "
                      + "; ".join(f"{way} {' / '.join(f'{v:.4f}' for v in vs)}"
                                  for way, vs in ms.items())
                      + f" ms (bound {bound_ms:.4f} ms); bit for bit the "
                        f"plain version: {exact.get(label)}")
            del src, dst, calls, keep, ox, oxt
        del xs, xts, xps, refs
        torch.cuda.empty_cache()
    return rows


def flash_launch(fn, q, k, v, window):
    out = torch.empty_like(q)
    bh, s_len, hd = q.shape
    err = fn(build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), bh, s_len, s_len, hd, 1, 1,
             window, hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    cs.require(err == 0, f"launch failed: CUDA error {err}")
    return out


def sweep_flash(card: str, fns: dict) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bh, s_len, hd, window = FLASH_SHAPE
    kw = dict(causal=True, window=window)
    pairs = bh * int(attention_mask(s_len, s_len, device=dev, **kw).sum())
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(bh, s_len, hd, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        ref = attention_ref(q, k, v, **kw)
        live = torch.ones(s_len, dtype=torch.bool, device=dev)
        ok = {}
        for label, fn in fns.items():
            out = flash_launch(fn, q, k, v, window)
            if dtype == torch.float32:
                ok[label] = bool(torch.allclose(out, ref, **cs.FLASH_F32_TOL))
            else:
                err = (out.float() - ref.float()).abs().max().item()
                ok[label] = (err <= cs.FLASH_BF16_ATOL and cs.bf16_reading(
                    out, ref, q, k, v, live, **kw) <= 1.0)
        calls = {label: (lambda fn=fn: flash_launch(fn, q, k, v, window))
                 for label, fn in fns.items()}
        calls["sdpa"] = lambda: cs.library_attention(q, k, v, True, window)
        times = both_ways(list(calls), lambda label: cs.cuda_ms(
            calls[label], reps=20))
        if dtype == torch.float32:
            flops, peak = 3 * 4 * hd * pairs, cs.PEAK_TF32_FLOPS
        else:
            flops, peak = 4 * hd * pairs, cs.PEAK_BF16_FLOPS
        bound_ms = cs.bound(4 * bh * s_len * hd * q.element_size(), flops,
                            peak)["bound_ms"]
        shape = f"({bh}, {s_len}, {hd}) window {window} {str(dtype)[6:]}"
        for label, ts in times.items():
            ms = float(np.mean(ts))
            rows.append({"card": card, "kernel": FLASH, "shape": shape,
                         "variant": label, "ms": ts, "bound_ms": bound_ms,
                         "within_tol": ok.get(label)})
            print(f"[{card}] {FLASH} {shape} {label}: "
                  f"{' / '.join(f'{t:.4f}' for t in ts)} ms "
                  f"({bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms); "
                  f"within phase 11's gates: {ok.get(label, 'n/a')}")
        del q, k, v, ref
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another src/repro_torch/kernels directory")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS), help="the kernels to sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    fns = build_variants({name: variant_roots(name, args.baseline)
                          for name in args.only})
    sweeps = {RMSNORM: sweep_rmsnorm, GOSSIP: sweep_gossip, P2P: sweep_p2p,
              FLASH: sweep_flash}
    rows = [row for name in args.only
            for row in sweeps[name](card, fns[name])]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_sweep.json").write_text(json.dumps(rows, indent=1))
    ok = all(r.get("bit_exact", r.get("within_tol")) is not False
             for r in rows)
    print(f"every variant agrees with the plain version: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
