"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

It needs one card, the CUDA toolkit (``nvcc``) and this checkout; it never
imports JAX or the JAX package.  Phases, each fatal on failure:

  1. device and build: the card, the TF32 settings (both set off: f32
     means f32 here), the hand kernel built from ``src/`` with nvcc's
     register and spill report;
  2. the kernel against its plain PyTorch version on the same inputs, at
     the slice's real shape (16 workers x ResNet-18-CIFAR's padded width,
     f32) and at a small bf16 shape, with the exact identities (an idle row
     with eta = 0 is untouched, padding columns stay 0), and its time beside
     its memory bound and the plain version's time;
  3. the slice: ResNet-18-CIFAR at full width, 16 workers on a ring, a
     SyntheticCIFAR batch of 32 per worker, the baseline and the A2CiD2 arm
     for 4 rounds each at one comm per gradient, through
     ``Simulator.run_schedule``, with every comm batch and gradient tick of
     the replay timed by CUDA events; the kernel's launch count must equal
     the stream's comm steps, losses must be finite, and the engine must
     agree with the per-event replay on a quadratic (n=16, d=256).

The line before the last is a JSON summary of every kernel of the path, the
last line the status object.  Every printed number is prefixed with the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
N_WORKERS, BATCH, ROUNDS, SEED, GAMMA = 16, 32, 4, 0, 0.01
F32_TOL = 1e-5      # kernel vs plain, f32: same correctly rounded ops, exp
BF16_TOL = 5e-2     # bf16: a one-ulp flip of c moves an output by < 2^-6 * 4
ENGINE_TOL = 1e-5   # engine vs per-event replay, as the JAX package holds it
FLOPS_PER_ELEM = 9  # m, 2 scaled subtractions, d, c*d, 2 outputs: 9 f32 ops
KERNEL = {"name": "mixing_gossip_stacked", "route": "cuda",
          "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                    "mixing_gossip_stacked.cu",
          "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:222"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def involution(w: int, idle: int, seed: int) -> np.ndarray:
    """Random matching on w workers leaving ``idle`` rows self-partnered."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(w)
    partner = np.arange(w, dtype=np.int32)
    for k in range((w - idle) // 2):
        i, j = perm[2 * k], perm[2 * k + 1]
        partner[i], partner[j] = j, i
    return partner


def check_kernel(card, kernel, ref, dyn, w, d, d_real, dtype, tol, gen):
    """Kernel vs plain version on one input set, plus the exact
    identities.  Returns (max_abs_err, inputs)."""
    dev = torch.device("cuda")
    partner_np = involution(w, idle=4, seed=d)
    partner = torch.from_numpy(partner_np).to(dev)
    idle = torch.from_numpy(partner_np == np.arange(w)).to(dev)
    dt = torch.rand(w, generator=gen, device=dev) * 1.5
    x = torch.randn(w, d, generator=gen, device=dev).to(dtype)
    xt = torch.randn(w, d, generator=gen, device=dev).to(dtype)
    x[:, d_real:] = 0
    xt[:, d_real:] = 0
    rx, rxt = ref(x, xt, partner, dt, **dyn)
    kx, kxt = kernel(x, xt.clone(), partner, dt, **dyn)
    torch.cuda.synchronize()
    err = max((kx.float() - rx.float()).abs().max().item(),
              (kxt.float() - rxt.float()).abs().max().item())
    print(f"[{card}] kernel vs plain {dtype} ({w}, {d}): max abs err "
          f"{err:.3e} (tolerance {tol:g})")
    require(err <= tol, f"kernel disagrees with plain version: {err}")
    require(bool((kx[:, d_real:] == 0).all() and (kxt[:, d_real:] == 0)
                 .all()), "padding columns did not stay 0")
    kx0, kxt0 = kernel(x, xt.clone(), partner, dt, eta=0.0, alpha=0.5,
                       alpha_t=0.5)
    require(torch.equal(kx0[idle], x[idle])
            and torch.equal(kxt0[idle], xt[idle]),
            "an idle row with eta = 0 was changed")
    print(f"[{card}] identities exact: idle rows with eta=0 untouched, "
          f"{d - d_real} padding columns stay 0")
    return err, (x, xt, partner, dt)


def phase_kernel(card, d, d_real, dyn):
    from repro_torch.kernels.a2cid2_mixing.kernel import mixing_gossip_stacked
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_stacked

    def plain(*args, **kw):  # the plain PyTorch version, on the card
        return gossip_event_stacked(*args, backend="ref", **kw)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_kernel(card, mixing_gossip_stacked, plain, dyn, N_WORKERS, 4096,
                 4096 - 54, torch.bfloat16, BF16_TOL, gen)
    err, (x, xt, partner, dt) = check_kernel(
        card, mixing_gossip_stacked, plain, dyn,
        N_WORKERS, d, d_real, torch.float32, F32_TOL, gen)
    w = N_WORKERS
    xt_run = xt.clone()
    ms = cuda_ms(lambda: mixing_gossip_stacked(x, xt_run, partner, dt,
                                               **dyn), reps=20)
    plain_ms = cuda_ms(lambda: plain(x, xt, partner, dt, **dyn), reps=5,
                       warmup=1)
    # each input read once (x, x~, partner, dt), each output written once
    nbytes = 4 * w * d * x.element_size() + 2 * w * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_ELEM * w * d / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{card}] kernel ({w}, {d}) f32: {ms:.4f} ms over 20 launches, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; ops bound {ops_ms:.4f} ms), "
          f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved, plain version "
          f"{plain_ms:.4f} ms; no single PyTorch call computes this "
          f"function (library_ms null)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_slice(card, params0, cfg, stream_cls, grad_fn_for):
    from repro_torch.core import (FlatGossipEngine, Simulator,
                                  coalesce_schedule, coalesced_stream,
                                  make_schedule, params_from_graph,
                                  ring_graph)
    from repro_torch.kernels.a2cid2_mixing.kernel import mixing_gossip_stacked
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    sched = make_schedule(graph, ROUNDS, comms_per_grad=1.0, seed=SEED)
    steps = coalesced_stream(coalesce_schedule(sched),
                             np.zeros(N_WORKERS, np.float32))
    comm_steps = int((~steps.is_grad).sum())
    base_grad = grad_fn_for(cfg, stream_cls(batch_size=BATCH))
    # CUDA-event pairs around each gradient call and each comm batch of the
    # replay, keyed by (arm, "grad" | "comm")
    events: dict[tuple[str, str], list] = {}
    arm_now = ["warm-up"]

    def timed(kind, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events.setdefault((arm_now[0], kind), []).append((start, end))
            return out
        return call

    timed_grad_fn = timed("grad", base_grad)
    engine_batch = FlatGossipEngine.batch

    def timed_batch(self, *args):
        return timed("comm", engine_batch)(self, *args)

    sims = {arm: Simulator(timed_grad_fn, params_from_graph(graph, accel),
                           GAMMA)
            for arm, accel in (("baseline", False), ("a2cid2", True))}
    # warm-up: one model step outside the measured replay (cuDNN set-up)
    warm = sims["baseline"].init(params0, N_WORKERS,
                                 torch.Generator(device=dev).manual_seed(9))
    base_grad(warm.x, warm.generator, torch.arange(N_WORKERS, device=dev))
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    mixing_gossip_stacked.launches = 0
    walls, traces = {}, {}
    FlatGossipEngine.batch = timed_batch
    try:
        for arm, sim in sims.items():
            arm_now[0] = arm
            gen = torch.Generator(device=dev).manual_seed(SEED + 1)
            state = sim.init(params0, N_WORKERS, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, trace = sim.run_schedule(state, sched)
            torch.cuda.synchronize()
            walls[arm] = (time.perf_counter() - t0) * 1e3
            traces[arm] = trace
            del state, final
    finally:
        FlatGossipEngine.batch = engine_batch
    launches = mixing_gossip_stacked.launches
    peak = torch.cuda.max_memory_allocated()
    ms = {key: [s.elapsed_time(e) for s, e in pairs]
          for key, pairs in events.items() if key[0] in sims}

    require(launches == 2 * comm_steps,
            f"kernel launched {launches} times, stream has {comm_steps} "
            f"comm steps per arm")
    for arm, tr in traces.items():
        require(tr.loss.shape == (ROUNDS,)
                and bool(torch.isfinite(tr.loss).all())
                and bool(torch.isfinite(tr.consensus).all()),
                f"{arm}: non-finite or misshapen trace")
        print(f"[{card}] {arm}: loss {tr.loss.tolist()} consensus "
              f"{tr.consensus.tolist()} replay {walls[arm]:.1f} ms")
    print(f"[{card}] slice: {comm_steps} comm steps + {ROUNDS} gradient "
          f"ticks per arm; kernel launches {launches} == 2 x {comm_steps}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    for arm, wall in walls.items():
        comm, grad = ms[(arm, "comm")], ms[(arm, "grad")]
        require(len(comm) == comm_steps and len(grad) == ROUNDS,
                f"{arm}: timed {len(comm)} comm batches and {len(grad)} "
                f"gradient ticks")
        rest = (wall - sum(comm) - sum(grad)) / ROUNDS
        print(f"[{card}] {arm} step breakdown (CUDA events in the replay): "
              f"comm batch {np.mean(comm):.4f} ms x {comm_steps} "
              f"{[round(t, 4) for t in comm]}, gradient tick model "
              f"(16 workers x {BATCH}) {np.mean(grad):.2f} ms x {ROUNDS}, "
              f"rest per tick (pack, update, metrics, mix, host) "
              f"{rest:.2f} ms; replay {wall:.1f} ms")
    return launches


def phase_engine_vs_reference(card):
    from repro_torch.core import (Simulator, make_schedule,
                                  params_from_graph, ring_graph)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b = torch.randn(N_WORKERS, 256, generator=gen, device=dev)

    def quad(x, generator, ids):
        return 0.5 * ((x - b[ids]) ** 2).sum(dim=1), x - b[ids]

    graph = ring_graph(N_WORKERS)
    sim = Simulator(quad, params_from_graph(graph, True), GAMMA)
    state = sim.init(torch.zeros(256, device=dev), N_WORKERS, gen)
    sched = make_schedule(graph, 20, comms_per_grad=1.5, seed=SEED + 2)
    ef, et = sim.run_schedule(state, sched)
    rf, rt = sim.run_schedule(state, sched, engine=False)
    for a, c in ((et.loss, rt.loss), (et.consensus, rt.consensus),
                 (ef.x, rf.x), (ef.x_tilde, rf.x_tilde)):
        torch.testing.assert_close(a, c, rtol=ENGINE_TOL, atol=1e-6)
    err = (ef.x - rf.x).abs().max().item()
    print(f"[{card}] engine vs per-event replay, quadratic n=16 d=256, 20 "
          f"rounds: max abs err {err:.3e} (tolerance {ENGINE_TOL:g})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.flatbuf import FlatLayout
    from repro_torch.core.a2cid2 import params_from_graph
    from repro_torch.core.graphs import ring_graph
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.kernels.a2cid2_mixing.kernel import build
    from repro_torch.models.resnet import (init_resnet, resnet18_cifar,
                                           resnet_grad_fn)

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[{card}] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    lib, log = build()
    print(f"[{card}] built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[{card}] ptxas: {line.strip()}")

    cfg = resnet18_cifar()
    params0 = init_resnet(torch.Generator(device="cuda").manual_seed(SEED),
                          cfg)
    layout = FlatLayout.from_pytree(params0)
    print(f"[{card}] resnet18_cifar: {layout.d_real} parameters in "
          f"{len(layout.specs)} leaves, D = {layout.d}")
    dyn = params_from_graph(ring_graph(N_WORKERS), True)
    row = phase_kernel(card, layout.d, layout.d_real,
                       dict(eta=dyn.eta, alpha=dyn.alpha,
                            alpha_t=dyn.alpha_tilde))
    torch.cuda.empty_cache()
    launches = phase_slice(card, params0, cfg, SyntheticCIFAR,
                           resnet_grad_fn)
    phase_engine_vs_reference(card)

    print(card)
    print(json.dumps({"kernels": [{**KERNEL, "launches": launches, **row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
