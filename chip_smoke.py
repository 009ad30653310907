"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

It needs one card, the CUDA toolkit (``nvcc``) and this checkout; it never
imports JAX or the JAX package.  Phases, each fatal on failure:

  1. device and build: the card, the TF32 settings (both set off: f32
     means f32 here), all eight hand kernels built from ``src/`` in parallel
     (``kernels/build.py``) with nvcc's register and spill report;
  2. the clean kernel ``mixing_gossip_stacked`` against its plain PyTorch
     version on the same inputs, at the slice's real shape (16 workers x
     ResNet-18-CIFAR's padded width, f32) and at a small bf16 shape, with
     the exact identities (an idle row with eta = 0 is untouched, padding
     columns stay 0), and its time beside its memory bound and the plain
     version's time;
  3. the clean slice: ResNet-18-CIFAR at full width, 16 workers on a ring,
     a SyntheticCIFAR batch of 32 per worker, the baseline and the A2CiD2
     arm for 4 rounds each at one comm per gradient, through
     ``Simulator.run_schedule``, with every comm batch and gradient tick
     timed by CUDA events; the clean kernel's launch count must equal the
     stream's comm steps (and the channel kernel must not launch), losses
     must be finite, and the engine must agree with the per-event replay on
     a quadratic (n=16, d=256);
  4. the channel kernel ``channel_gossip_stacked`` against its plain
     version at the real shape (f32) and a small bf16 shape, with and
     without a coordinate clip, with the rejection mask, on rows that mix
     honest reads, a 1e3 scale, a sign flip, a rejected read (mscale 0), a
     norm-clipped read and idle rows; the exact reductions (bitwise the
     clean kernel at corrupt 0 / mscale 1 / no clip, a rejected row with
     eta = 0 untouched, padding 0, the mask exactly ``mscale == 0``); its
     time beside its bound and the plain version's;
  5. the channel slice: the same model and workers for 6 rounds over a
     hostile channel (stale reads from a ring of 2 snapshots, a 1e3 scale
     attack on 2 of the 16 ring edges at a 50% duty cycle, 10% drops), two
     A2CiD2 arms with the trim rule at tau = 5: static, and the
     self-healing defense.  The channel kernel must launch once per comm
     step (the clean kernel never), losses and consensus must be finite,
     and the defense must reject or quarantine at least once.  Each comm
     kernel, partner gather, delta-norm reduce and gradient tick is timed
     by CUDA events inside the replay;
  6. engine against the per-event replay for the channel and the defense
     flavours on the hostile channel (quadratic, n=16, d=256, 20 rounds),
     the defense's rejection and quarantine counts exactly equal;
  7. the world-batched kernels ``mixing_gossip_worlds`` and
     ``channel_gossip_worlds`` against their plain versions at (4 worlds,
     16 workers, ResNet-18-CIFAR's padded width) f32 (max abs err <= 1e-5)
     and a small bf16 shape (exactly), in one launch that mixes baseline
     and A2CiD2 worlds; per world bit for bit the stacked kernels; the
     exact identities (an idle row of an eta = 0 world untouched, padding
     0, the mask exactly ``mscale == 0``, the channel worlds kernel at
     corrupt 0 / mscale 1 / no clip bitwise the clean one); each time the
     mean of 20 launches beside its bound and the plain version's time;
  8. the clean worlds slice: the same model and workers, a
     ``WorldSweep`` of {adpsgd, a2cid2} x comms_per_grad {1, 2} (B = 4
     ragged worlds) for 4 rounds through ``Simulator.run_worlds``; the
     clean worlds kernel launches once per shared comm step and no other
     gossip kernel launches; per-step breakdown by CUDA events (the
     gradient tick of each world, the comm kernel, the mixing pass) and
     the peak device memory;
  9. the channel and defense worlds slice: 6 rounds over the hostile
     channel of phase 5, B = 4 worlds in ONE defense-flavour call, {static
     trim at tau 5, the self-healing defense} x {adpsgd, a2cid2}; the
     channel worlds kernel launches once per comm step and no other; each
     defense arm rejects or quarantines; the breakdown adds the partner
     gather and the delta-norm reduce;
 10. each world of ``run_worlds`` against its own serial ``run_schedule``
     on the card (quadratic, n=16, d=256, 20 rounds, B = 4) for the plain,
     channel and defense flavours, within 1e-5, the defense counts exactly
     equal;
 11. the flash attention kernel ``flash_attention_bhsd`` against its plain
     version at the prefill shapes of nano-lm (96, 1024, 64) and Qwen3-0.6B
     (32, 4096, 128) causal f32, (96, 1000, 64) causal with a window of
     256, (2, 130, 64) against 384 keys without the mask, and (96, 1024,
     64) bf16, on live rows (atol 2e-5, rtol 1e-4 at f32, the JAX package's
     tolerance; atol 3e-2 at bf16, the JAX package's); the kernel's 0 on
     rows with no live column pinned exactly; each shape's time (mean of
     20 launches) beside its bound, the plain version's time and
     ``scaled_dot_product_attention``'s;
 12. the RMSNorm kernel ``rmsnorm_2d`` against its plain version at
     (8192, 768) and (8192, 1024) f32 and bf16, (130, 768) and (1, 256)
     (atol 1e-5 at f32, 2e-2 at bf16), with its time beside its bound,
     the plain version's and ``torch.nn.functional.rms_norm``'s.  No model
     calls it (nor does the JAX package's): it launches on no main path;
 13. (A) the nano-lm gossip replay at full width (12 layers, d_model 768,
     128,404,224 parameters), ``launch.train.run_sim`` with the CLI's
     defaults (8 workers on a ring, ``LMTaskStream`` batch 8 x 128
     tokens, lr 0.05, one comm per gradient), 4 rounds, a baseline and an
     A2CiD2 arm: ``mixing_gossip_stacked`` launches once per comm step and
     no other kernel launches (the xla attention path); losses and
     consensus finite; model tick, comm batch and the rest per round timed
     by CUDA events; the engine against the per-event replay on the same
     model (3 rounds at 1.5 comms per gradient) within 1e-5;
 14. (B) the prefill with the flash kernel in every attention layer
     (``launch.steps.make_prefill_step``, ``attention_impl="pallas"``): on
     the A2CiD2 arm's consensus model (``worker_mean``) over a held-out
     batch of 8 x 1024 tokens of the same stream, and on Qwen3-0.6B at its
     published width (28 layers, 596,180,992 parameters, weights from seed
     0) over 2 x 4096 random tokens: flash launches equal the attention
     layers of one forward (12, 28), the logits match the xla path within
     max|d| / max|logit| < 2e-4 (the JAX package's model tolerance), the CE
     is finite; the forward's time and the flash kernel's share of it;
 15. the per-worker event kernel ``p2p_mixing`` against its plain version at
     ResNet-18-CIFAR's padded width (11,171,328) f32 and bf16, bit for
     bit, with x~ written in place beside a fresh out_x, the exact
     identities (xp = x with eta = 0 a no-op, alpha = alpha~ = 0 the mixing
     step, padding 0), each row bit for bit what ``mixing_gossip_stacked``
     computes for it; its time beside its 0.0667 ms bound;
 16. ``mixing_p2p`` through ``ops.gossip_event_pytree`` on the 56 leaves of
     the ResNet-18-CIFAR tree, f32 and bf16, bit for bit its plain version,
     plus odd lengths and views at odd element offsets; one tree launches
     it exactly 56 times and nothing else; the time per tree beside the
     summed bound;
 17. the SPMD slice: ``GossipTrainer.from_world`` on ResNet-18-CIFAR, 16
     workers on a ring in lockstep over the single-card worker axis,
     ``SyntheticCIFAR`` batch 32 per worker, ``sgd()`` (0.9, 5e-4), lr 0.1,
     2 comms per step, 4 steps of a baseline, an A2CiD2 and a channel arm
     (always-on 1e3 scale on 2 edges, 10% drops, stale reads from a ring of
     2, trim at tau 5): ``p2p_mixing`` launches == steps x comms x 16 in
     the clean arms, the (1, D) ``channel_gossip_stacked`` the same in the
     channel arm, no other kernel; the per-worker gradients, the kernel per
     event and the rest of the step timed by CUDA events;
 18. the stacked slice: ``StackedGossipTrainer`` on the same model and arms,
     ``mixing_gossip_stacked`` launches == steps x comms (the channel kernel
     once per event not dropped), the same spans timed; the SPMD and the
     stacked event loops per row bit for bit on shared gaps; one
     ``make_pair_ring_step`` and one ``make_ar_step``: finite, no gossip
     kernel.

The line before the last is a JSON summary of every kernel, the last line
the status object.  Every printed number is prefixed with the card's name
and power limit.
"""
from __future__ import annotations

import dataclasses
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
# the channel slice: 6 rounds so that stale reads reach 2 snapshots back;
# schedule seed 1 puts 8 corrupted reads in them, the first in round 0
CHANNEL_ROUNDS, CHANNEL_SEED = 6, 1
# the repo's own channel settings (benchmarks/run.py, _CHAN_BENCH): scale
# 1e3 at a 50% duty cycle, stale prob 1, trim at tau 5
ROBUST_CLIP = 5.0
F32_TOL = 1e-5      # kernel vs plain, f32: same correctly rounded ops, exp
# bf16: the kernels round every intermediate and every scalar where the
# plain versions do, so they agree exactly
BF16_TOL = 0.0
ENGINE_TOL = 1e-5   # engine vs per-event replay, as the JAX package holds it
FLOPS_PER_ELEM = 9  # m, 2 scaled subtractions, d, c*d, 2 outputs: 9 f32 ops
# (1+c)*xp, x - that, * mscale, then the 9 of the clean batch less its m:
# 11 f32 ops an element (no clip)
CHANNEL_FLOPS_PER_ELEM = 11
# the world-batched slices: B = 4 worlds in one call
N_WORLDS = 4
PEAK_BF16_FLOPS = 989e12   # dense tensor-core rate (NVIDIA data sheet)
# flash kernel vs plain: the JAX package's kernel-vs-oracle tolerances
FLASH_F32_TOL = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16_ATOL = 3e-2
RMSNORM_F32_ATOL = 1e-5    # the JAX package's rmsnorm kernel test
RMSNORM_BF16_ATOL = 2e-2
MODEL_TOL = 2e-4           # pallas vs xla logits, max|d| / max|logit|
# (A): the CLI defaults of launch/train.py, 4 rounds, full nano-lm
LM_ROUNDS, LM_WORKERS = 4, 8
NANO_PARAMS, QWEN_PARAMS = 128_404_224, 596_180_992  # jax.eval_shape counts
KERNELS = {
    "mixing_gossip_stacked": {
        "name": "mixing_gossip_stacked", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                  "mixing_gossip_stacked.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:222"},
    "channel_gossip_stacked": {
        "name": "channel_gossip_stacked", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                  "channel_gossip_stacked.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:524"},
    "mixing_gossip_worlds": {
        "name": "mixing_gossip_worlds", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                  "mixing_gossip_worlds.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:306"},
    "channel_gossip_worlds": {
        "name": "channel_gossip_worlds", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                  "channel_gossip_worlds.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:408"},
    "p2p_mixing": {
        "name": "p2p_mixing", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/p2p_mixing.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:155"},
    "mixing_p2p": {
        "name": "mixing_p2p", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/mixing_p2p.cu",
        "replaces": "src/repro/kernels/a2cid2_mixing/kernel.py:90"},
    "flash_attention_bhsd": {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bhsd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:81"},
    "rmsnorm_2d": {
        "name": "rmsnorm_2d", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_2d.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:27"},
}


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


def graph_ms(fn, calls: int, reps: int = 10):
    """Device time of one call of ``fn`` with the host taken out: ``calls``
    calls captured in one CUDA graph (after a warm-up on a side stream),
    the graph replayed ``reps`` times.  Returns (ms a call, the output of
    the last captured call, as the replays left it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return cuda_ms(graph.replay, reps=reps, warmup=1) / calls, out


def involution(w: int, idle: int, seed: int) -> np.ndarray:
    """Random matching on w workers leaving ``idle`` rows self-partnered."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(w)
    partner = np.arange(w, dtype=np.int32)
    for k in range((w - idle) // 2):
        i, j = perm[2 * k], perm[2 * k + 1]
        partner[i], partner[j] = j, i
    return partner


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS
          ) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the inputs' type's peak rate (f32 unless named),
    whichever is larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops_ms": ops_ms}


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (``kernels/<package>/kernel.py``), whose
    ``launches`` counts its launches."""
    import importlib
    from repro_torch.kernels.build import PACKAGES
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{PACKAGES[name]}.kernel"), name)
        for name in KERNELS}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def only_launched(launches: dict, name: str) -> bool:
    """True when no kernel other than ``name`` launched."""
    return all(v == 0 for k, v in launches.items() if k != name)


class ReplayTimer:
    """CUDA-event pairs around calls made inside a replay, keyed by
    (arm, kind); nothing waits for the card until ``ms`` is read."""

    def __init__(self):
        self.events: dict[tuple[str, str], list] = {}
        self.arm = "warm-up"

    def wrap(self, kind, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.setdefault((self.arm, kind), []).append((start, end))
            return out
        return call

    def ms(self, arm, kind) -> list[float]:
        return [s.elapsed_time(e) for s, e in self.events.get((arm, kind),
                                                              [])]


# ---------------------------------------------------------- clean kernel
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
    b = bound(nbytes, FLOPS_PER_ELEM * w * d)
    print(f"[{card}] kernel ({w}, {d}) f32: {ms:.4f} ms over 20 launches, "
          f"bound {b['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; ops bound "
          f"{b['ops_ms']:.4f} ms), {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s "
          f"achieved, plain version {plain_ms:.4f} ms; no single PyTorch "
          f"call computes this function (library_ms null)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None}


def phase_slice(card, params0, cfg, stream_cls, grad_fn_for):
    from repro_torch.core import (FlatGossipEngine, Simulator,
                                  coalesce_schedule, coalesced_stream,
                                  make_schedule, params_from_graph,
                                  ring_graph)
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    sched = make_schedule(graph, ROUNDS, comms_per_grad=1.0, seed=SEED)
    steps = coalesced_stream(coalesce_schedule(sched),
                             np.zeros(N_WORKERS, np.float32))
    comm_steps = int((~steps.is_grad).sum())
    base_grad = grad_fn_for(cfg, stream_cls(batch_size=BATCH))
    timer = ReplayTimer()
    engine_batch = FlatGossipEngine.batch
    sims = {arm: Simulator(timer.wrap("grad", base_grad),
                           params_from_graph(graph, accel), GAMMA)
            for arm, accel in (("baseline", False), ("a2cid2", True))}
    # warm-up: one model step outside the measured replay (cuDNN set-up)
    warm = sims["baseline"].init(params0, N_WORKERS,
                                 torch.Generator(device=dev).manual_seed(9))
    base_grad(warm.x, warm.generator, torch.arange(N_WORKERS, device=dev))
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    walls, traces = {}, {}
    FlatGossipEngine.batch = timer.wrap("comm", engine_batch)
    reset_launches()
    try:
        for arm, sim in sims.items():
            timer.arm = arm
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
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    require(launches["mixing_gossip_stacked"] == 2 * comm_steps,
            f"clean kernel launched {launches['mixing_gossip_stacked']} "
            f"times, stream has {comm_steps} comm steps per arm")
    require(only_launched(launches, "mixing_gossip_stacked"),
            f"another kernel launched on the clean path: {launches}")
    for arm, tr in traces.items():
        require(tr.loss.shape == (ROUNDS,)
                and bool(torch.isfinite(tr.loss).all())
                and bool(torch.isfinite(tr.consensus).all()),
                f"{arm}: non-finite or misshapen trace")
        print(f"[{card}] {arm}: loss {tr.loss.tolist()} consensus "
              f"{tr.consensus.tolist()} replay {walls[arm]:.1f} ms")
    print(f"[{card}] clean slice: {comm_steps} comm steps + {ROUNDS} "
          f"gradient ticks per arm; clean kernel launches "
          f"{launches['mixing_gossip_stacked']} == 2 x {comm_steps}, "
          f"channel kernel 0; peak memory {peak / 2**30:.2f} GiB")
    for arm, wall in walls.items():
        comm, grad = timer.ms(arm, "comm"), timer.ms(arm, "grad")
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
    return launches["mixing_gossip_stacked"]


def quadratic_sim(dev, gen, scale=1.0, **kw):
    """A2CiD2 on a ring of 16 workers pulling toward their own optimum
    ``scale * N(0, 1)`` in d = 256."""
    from repro_torch.core import Simulator, params_from_graph, ring_graph
    b = scale * torch.randn(N_WORKERS, 256, generator=gen, device=dev)

    def quad(x, generator, ids):
        return 0.5 * ((x - b[ids]) ** 2).sum(dim=1), x - b[ids]

    sim = Simulator(quad, params_from_graph(ring_graph(N_WORKERS), True),
                    GAMMA, **kw)
    return sim, sim.init(torch.zeros(256, device=dev), N_WORKERS, gen)


def phase_engine_vs_reference(card):
    from repro_torch.core import make_schedule, ring_graph
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sim, state = quadratic_sim(dev, gen)
    sched = make_schedule(ring_graph(N_WORKERS), 20, comms_per_grad=1.5,
                          seed=SEED + 2)
    ef, et = sim.run_schedule(state, sched)
    rf, rt = sim.run_schedule(state, sched, engine=False)
    for a, c in ((et.loss, rt.loss), (et.consensus, rt.consensus),
                 (ef.x, rf.x), (ef.x_tilde, rf.x_tilde)):
        torch.testing.assert_close(a, c, rtol=ENGINE_TOL, atol=1e-6)
    err = (ef.x - rf.x).abs().max().item()
    print(f"[{card}] engine vs per-event replay, quadratic n=16 d=256, 20 "
          f"rounds: max abs err {err:.3e} (tolerance {ENGINE_TOL:g})")


# -------------------------------------------------------- channel kernel
def channel_inputs(w, d, d_real, dtype, gen, with_inf=False):
    """Rows: honest pairs (corrupt 0), a 1e3 scale read, a sign-flip read,
    a rejected read (mscale 0), a norm-clipped read (mscale 0.3), and four
    idle rows; the partner values pre-gathered as the engine does."""
    dev = torch.device("cuda")
    partner = torch.from_numpy(involution(w, idle=4, seed=d + 1)).to(dev)
    x = torch.randn(w, d, generator=gen, device=dev).to(dtype)
    xt = torch.randn(w, d, generator=gen, device=dev).to(dtype)
    x[:, d_real:] = 0
    xt[:, d_real:] = 0
    xp = x.index_select(0, partner.long())
    active = (partner != torch.arange(w, device=dev)).nonzero().flatten()
    corrupt = torch.zeros(w, device=dev)
    mscale = torch.ones(w, device=dev)
    corrupt[active[0]], corrupt[active[1]] = 999.0, -2.0
    mscale[active[2]], mscale[active[3]] = 0.0, 0.3
    if with_inf:   # inf * mscale 0 = NaN in m: the clip must keep it
        xp[active[2], :8] = float("inf")
    dt = torch.rand(w, generator=gen, device=dev) * 1.5
    return x, xt, xp, corrupt, mscale, dt, partner, active[2]


def check_channel(card, dyn, w, d, d_real, dtype, tol, gen, with_inf):
    from repro_torch.kernels.a2cid2_mixing.kernel import (
        channel_gossip_stacked, mixing_gossip_stacked)
    from repro_torch.kernels.a2cid2_mixing.ops import channel_event_stacked
    x, xt, xp, corrupt, mscale, dt, partner, rejected = channel_inputs(
        w, d, d_real, dtype, gen, with_inf)
    err = 0.0
    for clip in (None, 2.5):
        for want_rej in (False, True):
            kw = dict(clip=clip, want_rej=want_rej, **dyn)
            ref = channel_event_stacked(x, xt, xp, corrupt, mscale, dt,
                                        backend="ref", **kw)
            out = channel_gossip_stacked(x, xt.clone(), xp, corrupt, mscale,
                                         dt, **kw)
            torch.cuda.synchronize()
            for k, r in zip(out[:2], ref[:2]):
                finite = torch.isfinite(r)
                require(torch.equal(finite, torch.isfinite(k))
                        and torch.equal(k[~finite].isnan(),
                                        r[~finite].isnan()),
                        f"{dtype} clip={clip}: non-finite entries differ")
                e = (k.float() - r.float())[finite].abs().max().item()
                ok = torch.allclose(k.float()[finite], r.float()[finite],
                                    rtol=tol, atol=tol)
                require(ok, f"{dtype} clip={clip}: channel kernel "
                            f"disagrees with plain version ({e})")
                err = max(err, e)
            if want_rej:
                require(torch.equal(out[2], ref[2])
                        and torch.equal(out[2], (mscale == 0).float()),
                        "rejection mask is not exactly mscale == 0")
            require(bool((out[0][:, d_real:] == 0).all()
                         and (out[1][:, d_real:] == 0).all()),
                    "padding columns did not stay 0")
    print(f"[{card}] channel kernel vs plain {dtype} ({w}, {d}), clip "
          f"none/2.5, with and without the mask: max abs err {err:.3e} "
          f"(tolerance {tol:g}); rejection mask == (mscale == 0) exactly"
          + ("; NaN from inf x 0 propagated through the clip" if with_inf
             else ""))
    # exact reductions: corrupt 0, mscale 1, no clip is the clean kernel
    ones, zeros = torch.ones_like(mscale), torch.zeros_like(corrupt)
    cx, cxt = mixing_gossip_stacked(x, xt.clone(), partner, dt, **dyn)
    kx, kxt = channel_gossip_stacked(x, xt.clone(),
                                     x.index_select(0, partner.long()),
                                     zeros, ones, dt, **dyn)
    require(torch.equal(cx, kx) and torch.equal(cxt, kxt),
            "corrupt 0 / mscale 1 / no clip is not the clean kernel")
    kx0, kxt0 = channel_gossip_stacked(x, xt.clone(),
                                       x.index_select(0, partner.long()),
                                       corrupt, mscale, dt, eta=0.0,
                                       alpha=0.5, alpha_t=0.5)
    require(torch.equal(kx0[rejected], x[rejected])
            and torch.equal(kxt0[rejected], xt[rejected]),
            "a rejected row with eta = 0 was changed")
    print(f"[{card}] channel identities exact: corrupt 0 / mscale 1 / no "
          f"clip == mixing_gossip_stacked bit for bit, a rejected row with "
          f"eta=0 untouched, {d - d_real} padding columns stay 0")
    return err, (x, xt, xp, corrupt, mscale, dt)


def phase_channel_kernel(card, d, d_real, dyn):
    from repro_torch.kernels.a2cid2_mixing.kernel import \
        channel_gossip_stacked
    from repro_torch.kernels.a2cid2_mixing.ops import channel_event_stacked
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    err_bf16, _ = check_channel(card, dyn, N_WORKERS, 4096, 4096 - 54,
                                torch.bfloat16, BF16_TOL, gen, True)
    err, (x, xt, xp, corrupt, mscale, dt) = check_channel(
        card, dyn, N_WORKERS, d, d_real, torch.float32, F32_TOL, gen, False)
    w = N_WORKERS
    xt_run = xt.clone()
    ms = cuda_ms(lambda: channel_gossip_stacked(x, xt_run, xp, corrupt,
                                                mscale, dt, **dyn), reps=20)
    plain_ms = cuda_ms(lambda: channel_event_stacked(
        x, xt, xp, corrupt, mscale, dt, backend="ref", **dyn), reps=5,
        warmup=1)
    # x, xp, x~ read once and two outputs written once; corrupt, mscale
    # and dt read once
    nbytes = 5 * w * d * x.element_size() + 3 * w * 4
    b = bound(nbytes, CHANNEL_FLOPS_PER_ELEM * w * d)
    print(f"[{card}] channel kernel ({w}, {d}) f32, no clip: {ms:.4f} ms "
          f"over 20 launches, bound {b['bound_ms']:.4f} ms "
          f"({nbytes / 1e9:.3f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"ops bound {b['ops_ms']:.4f} ms), "
          f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved, plain version "
          f"{plain_ms:.4f} ms; no single PyTorch call computes this "
          f"function (library_ms null)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None}


# --------------------------------------------------------- channel slice
def hostile_channel(graph):
    from repro_torch.core import ByzantineEdges, ChannelModel, DelayProcess
    picks = np.linspace(0, len(graph.edges), 2, endpoint=False).astype(int)
    return ChannelModel(
        delay=DelayProcess(horizon=2, prob=1.0),
        adversary=ByzantineEdges(tuple(graph.edges[i] for i in picks),
                                 "scale", scale=1e3, prob=0.5),
        drop_prob=0.1)


def phase_channel_slice(card, params0, cfg, stream_cls, grad_fn_for):
    from repro_torch.core import (AdaptiveDefense, FlatGossipEngine,
                                  Simulator, coalesce_schedule,
                                  coalesced_stream, make_schedule,
                                  params_from_graph, ring_graph)
    from repro_torch.core import engine as engine_mod
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    chan = hostile_channel(graph)
    sched = chan.apply(make_schedule(graph, CHANNEL_ROUNDS,
                                     comms_per_grad=1.0, seed=CHANNEL_SEED),
                       seed=CHANNEL_SEED)
    stream = coalesced_stream(coalesce_schedule(sched),
                              np.zeros(N_WORKERS, np.float32))
    comm_steps = int((~stream.is_grad).sum())
    corrupt_reads = int((stream.extras["corrupt"] != 0).sum())
    stale_reads = int((stream.extras["stale"] > 0).sum())
    base_grad = grad_fn_for(cfg, stream_cls(batch_size=BATCH))
    timer = ReplayTimer()
    norms = []   # (arm, nrm, corrupt) per reduce, read after the replay

    def recorded_norms(bx, xp, corrupt, axes=1):
        nrm = orig_norms(bx, xp, corrupt, axes)
        norms.append((timer.arm, nrm, corrupt))
        return nrm

    orig_kernel = engine_mod.channel_event_stacked
    orig_gather = FlatGossipEngine.partner_values
    orig_norms = FlatGossipEngine.delta_norms
    # the class attributes themselves (staticmethod objects), to restore
    saved = {k: FlatGossipEngine.__dict__[k] for k in ("partner_values",
                                                       "delta_norms")}
    params = params_from_graph(graph, True)
    sim = Simulator(timer.wrap("grad", base_grad), params, GAMMA,
                    robust_clip=ROBUST_CLIP, robust_rule="trim")
    arms = {"static trim": None, "defense": AdaptiveDefense()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, traces = {}, {}
    engine_mod.channel_event_stacked = timer.wrap("kernel", orig_kernel)
    FlatGossipEngine.partner_values = staticmethod(
        timer.wrap("gather", orig_gather))
    FlatGossipEngine.delta_norms = staticmethod(
        timer.wrap("norms", recorded_norms))
    reset_launches()
    try:
        for arm, defense in arms.items():
            timer.arm = arm
            state = sim.init(params0, N_WORKERS, torch.Generator(
                device=dev).manual_seed(SEED + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, trace = sim.run_schedule(state, sched, defense=defense)
            torch.cuda.synchronize()
            walls[arm] = (time.perf_counter() - t0) * 1e3
            traces[arm] = trace
            del state, final
    finally:
        engine_mod.channel_event_stacked = orig_kernel
        for k, v in saved.items():
            setattr(FlatGossipEngine, k, v)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    require(launches["channel_gossip_stacked"] == 2 * comm_steps,
            f"channel kernel launched {launches['channel_gossip_stacked']} "
            f"times, stream has {comm_steps} comm steps per arm")
    require(only_launched(launches, "channel_gossip_stacked"),
            f"another kernel launched on the channel path: {launches}")
    for arm, tr in traces.items():
        require(tr.loss.shape == (CHANNEL_ROUNDS,)
                and bool(torch.isfinite(tr.loss).all())
                and bool(torch.isfinite(tr.consensus).all()),
                f"{arm}: non-finite or misshapen trace")
        print(f"[{card}] channel {arm}: loss {tr.loss.tolist()} consensus "
              f"{tr.consensus.tolist()} replay {walls[arm]:.1f} ms")
    dtr = traces["defense"].defense
    acted = float((dtr.rejections + dtr.quarantined).sum())
    require(acted >= 1, "the defense rejected and quarantined nothing")
    print(f"[{card}] defense: tau {dtr.tau.tolist()} rejections "
          f"{dtr.rejections.tolist()} quarantined "
          f"{dtr.quarantined.tolist()}")
    for arm in arms:
        rows = [(n, c) for a, n, c in norms if a == arm]
        nrm = torch.cat([n for n, _ in rows]).cpu()
        cor = torch.cat([c for _, c in rows]).cpu()
        honest, bad = nrm[(cor == 0) & (nrm > 0)], nrm[cor != 0]
        print(f"[{card}] channel {arm}: delta norms, honest reads "
              f"{honest.min().item():.4g}..{honest.max().item():.4g} "
              f"({honest.numel()}), corrupted reads "
              f"{bad.min().item():.4g}..{bad.max().item():.4g} "
              f"({bad.numel()}); tau {ROBUST_CLIP:g}")
    print(f"[{card}] channel slice: {comm_steps} comm steps + "
          f"{CHANNEL_ROUNDS} gradient ticks per arm, {stale_reads} stale "
          f"and {corrupt_reads} corrupted reads; channel kernel launches "
          f"{launches['channel_gossip_stacked']} == 2 x {comm_steps}, clean "
          f"kernel 0; peak memory {peak / 2**30:.2f} GiB")
    for arm, wall in walls.items():
        parts = {k: timer.ms(arm, k) for k in ("kernel", "gather", "norms",
                                                "grad")}
        require(len(parts["kernel"]) == comm_steps
                and len(parts["grad"]) == CHANNEL_ROUNDS
                and len(parts["gather"]) == comm_steps
                and len(parts["norms"]) == comm_steps,
                f"{arm}: timed {[len(v) for v in parts.values()]} calls")
        rest = (wall - sum(sum(v) for v in parts.values())) / CHANNEL_ROUNDS
        print(f"[{card}] channel {arm} step breakdown (CUDA events in the "
              f"replay): kernel {np.mean(parts['kernel']):.4f} ms x "
              f"{comm_steps} {[round(t, 4) for t in parts['kernel']]}, "
              f"partner_values {np.mean(parts['gather']):.4f} ms x "
              f"{comm_steps}, delta_norms {np.mean(parts['norms']):.4f} ms "
              f"x {comm_steps}, gradient tick model (16 workers x {BATCH}) "
              f"{np.mean(parts['grad']):.2f} ms x {CHANNEL_ROUNDS}, rest "
              f"per tick (pack, update, metrics, ring push, mix, defense, "
              f"host) {rest:.2f} ms; replay {wall:.1f} ms")
    return launches["channel_gossip_stacked"]


def phase_channel_engine_vs_reference(card):
    from repro_torch.core import AdaptiveDefense, make_schedule, ring_graph
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    sched = hostile_channel(graph).apply(
        make_schedule(graph, 20, comms_per_grad=1.5, seed=SEED + 4),
        seed=SEED + 4)
    for flavour, defense in (("channel", None),
                             ("defense", AdaptiveDefense())):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        # optima at scale 0.1 keep honest delta norms (about 0.1-2) under
        # tau while the 1e3 scale reads land far above it
        sim, state = quadratic_sim(dev, gen, scale=0.1,
                                   robust_clip=ROBUST_CLIP)
        ef, et = sim.run_schedule(state, sched, defense=defense)
        rf, rt = sim.run_schedule(state, sched, defense=defense,
                                  engine=False)
        for a, c in ((et.loss, rt.loss), (et.consensus, rt.consensus),
                     (ef.x, rf.x), (ef.x_tilde, rf.x_tilde)):
            torch.testing.assert_close(a, c, rtol=ENGINE_TOL, atol=1e-6)
        err = (ef.x - rf.x).abs().max().item()
        extra = ""
        if defense is not None:
            require(torch.equal(et.defense.rejections, rt.defense.rejections)
                    and torch.equal(et.defense.quarantined,
                                    rt.defense.quarantined),
                    "defense counts differ between engine and per-event")
            torch.testing.assert_close(et.defense.tau, rt.defense.tau,
                                       rtol=ENGINE_TOL, atol=1e-6)
            extra = (f"; rejections {int(et.defense.rejections.sum())} and "
                     f"quarantined {int(et.defense.quarantined.sum())}, "
                     f"equal exactly")
        print(f"[{card}] {flavour} engine vs per-event replay, quadratic "
              f"n=16 d=256, 20 rounds, hostile channel: max abs err "
              f"{err:.3e} (tolerance {ENGINE_TOL:g}){extra}")


# ------------------------------------------------------- worlds kernels
def worlds_dyn(dyn, dev):
    """Per-world (eta, alpha, alpha_t) as (B,) f32: baseline worlds 0 and 2,
    A2CiD2 worlds 1 and 3."""
    base = dict(eta=0.0, alpha=0.5, alpha_t=0.5)
    rows = [base if b % 2 == 0 else dyn for b in range(N_WORLDS)]
    return tuple(torch.tensor([r[k] for r in rows], dtype=torch.float32,
                              device=dev)
                 for k in ("eta", "alpha", "alpha_t"))


def worlds_inputs(d, d_real, dtype, gen):
    """(B, 16, d) buffers, per-world involutions with idle rows, dt, and
    channel rows mixing honest, 1e3-scale, sign-flip, rejected and
    norm-clipped reads (as in phase 4), partner values pre-gathered."""
    dev = torch.device("cuda")
    w = N_WORKERS
    partner = torch.stack([torch.from_numpy(involution(w, idle=4,
                                                       seed=d + b))
                           for b in range(N_WORLDS)]).to(dev)
    x = torch.randn(N_WORLDS, w, d, generator=gen, device=dev).to(dtype)
    xt = torch.randn(N_WORLDS, w, d, generator=gen, device=dev).to(dtype)
    x[:, :, d_real:] = 0
    xt[:, :, d_real:] = 0
    dt = torch.rand(N_WORLDS, w, generator=gen, device=dev) * 1.5
    b_idx = torch.arange(N_WORLDS, device=dev)[:, None]
    xp = x[b_idx, partner.long()].contiguous()
    corrupt = torch.zeros(N_WORLDS, w, device=dev)
    mscale = torch.ones(N_WORLDS, w, device=dev)
    for b in range(N_WORLDS):
        active = (partner[b] != torch.arange(w, device=dev)).nonzero()
        active = active.flatten()
        corrupt[b, active[0]], corrupt[b, active[1]] = 999.0, -2.0
        mscale[b, active[2]], mscale[b, active[3]] = 0.0, 0.3
    return x, xt, xp, partner, dt, corrupt, mscale


def check_worlds(card, pw, d, d_real, dtype, tol, gen):
    """Both worlds kernels against their plain versions and, per world,
    against the stacked kernels bit for bit; the exact identities.
    Returns (max abs err clean, max abs err channel, inputs)."""
    from repro_torch.kernels.a2cid2_mixing import kernel as k
    from repro_torch.kernels.a2cid2_mixing.ops import (channel_event_worlds,
                                                       gossip_event_worlds)
    x, xt, xp, partner, dt, corrupt, mscale = worlds_inputs(d, d_real,
                                                            dtype, gen)
    rx, rxt = gossip_event_worlds(x, xt, partner, dt, *pw, backend="ref")
    kx, kxt = k.mixing_gossip_worlds(x, xt.clone(), partner, dt, *pw)
    torch.cuda.synchronize()
    err = max((kx.float() - rx.float()).abs().max().item(),
              (kxt.float() - rxt.float()).abs().max().item())
    del rx, rxt
    require(err <= tol, f"clean worlds kernel {dtype}: max abs err {err}")
    cerr = 0.0
    for clip in (None, 2.5):
        kw = dict(clip=clip, want_rej=True)
        ref = channel_event_worlds(x, xt, xp, corrupt, mscale, dt, *pw,
                                   backend="ref", **kw)
        out = k.channel_gossip_worlds(x, xt.clone(), xp, corrupt, mscale,
                                      dt, *pw, **kw)
        torch.cuda.synchronize()
        for a, r in zip(out[:2], ref[:2]):
            cerr = max(cerr, (a.float() - r.float()).abs().max().item())
        require(torch.equal(out[2], ref[2])
                and torch.equal(out[2], (mscale == 0).float()),
                "worlds rejection mask is not exactly mscale == 0")
        require(bool((out[0][:, :, d_real:] == 0).all()
                     and (out[1][:, :, d_real:] == 0).all()),
                "worlds padding columns did not stay 0")
        del ref
    require(cerr <= tol, f"channel worlds kernel {dtype}: max abs err "
                         f"{cerr}")
    cx, cxt = k.channel_gossip_worlds(x, xt.clone(), xp, corrupt, mscale,
                                      dt, *pw)
    for b in range(N_WORLDS):   # per world, the stacked kernels bit for bit
        dyn_b = dict(eta=float(pw[0][b]), alpha=float(pw[1][b]),
                     alpha_t=float(pw[2][b]))
        sx, sxt = k.mixing_gossip_stacked(x[b], xt[b].clone(), partner[b],
                                          dt[b], **dyn_b)
        require(torch.equal(kx[b], sx) and torch.equal(kxt[b], sxt),
                f"clean worlds kernel world {b} is not the stacked kernel")
        sx, sxt = k.channel_gossip_stacked(x[b], xt[b].clone(), xp[b],
                                           corrupt[b], mscale[b], dt[b],
                                           **dyn_b)
        require(torch.equal(cx[b], sx) and torch.equal(cxt[b], sxt),
                f"channel worlds kernel world {b} is not the stacked kernel")
    del cx, cxt
    # identities: an idle row of a baseline world untouched, padding 0, the
    # channel kernel at corrupt 0 / mscale 1 / no clip the clean kernel
    idle = partner == torch.arange(N_WORKERS, device=x.device)
    base = (pw[0] == 0)[:, None] & idle
    require(bool(base.any()) and torch.equal(kx[base], x[base])
            and torch.equal(kxt[base], xt[base]),
            "an idle row of an eta = 0 world was changed")
    require(bool((kx[:, :, d_real:] == 0).all()
                 and (kxt[:, :, d_real:] == 0).all()),
            "worlds padding columns did not stay 0")
    hx, hxt = k.channel_gossip_worlds(x, xt.clone(), xp,
                                      torch.zeros_like(corrupt),
                                      torch.ones_like(mscale), dt, *pw)
    require(torch.equal(hx, kx) and torch.equal(hxt, kxt),
            "corrupt 0 / mscale 1 / no clip is not the clean worlds kernel")
    del hx, hxt, kx, kxt
    print(f"[{card}] worlds kernels vs plain {dtype} ({N_WORLDS}, "
          f"{N_WORKERS}, {d}), baseline and A2CiD2 worlds in one launch: "
          f"max abs err clean {err:.3e}, channel {cerr:.3e} (clip none/2.5,"
          f" with the mask; tolerance {tol:g}); per world bit for bit the "
          f"stacked kernels; idle rows of eta=0 worlds untouched, "
          f"{d - d_real} padding columns 0, mask == (mscale == 0), channel "
          f"at corrupt 0 / mscale 1 / no clip == clean, all exactly")
    return err, cerr, (x, xt, xp, partner, dt, corrupt, mscale)


def phase_worlds_kernels(card, d, d_real, dyn):
    from repro_torch.kernels.a2cid2_mixing import kernel as k
    from repro_torch.kernels.a2cid2_mixing.ops import (channel_event_worlds,
                                                       gossip_event_worlds)
    dev = torch.device("cuda")
    pw = worlds_dyn(dyn, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    check_worlds(card, pw, 4096, 4096 - 54, torch.bfloat16, BF16_TOL, gen)
    err, cerr, (x, xt, xp, partner, dt, corrupt, mscale) = check_worlds(
        card, pw, d, d_real, torch.float32, F32_TOL, gen)
    bw = N_WORLDS * N_WORKERS
    rows = {}
    xt_run = xt.clone()
    runs = {
        "mixing_gossip_worlds": (
            lambda: k.mixing_gossip_worlds(x, xt_run, partner, dt, *pw),
            lambda: gossip_event_worlds(x, xt, partner, dt, *pw,
                                        backend="ref"),
            # x and x~ read once, two outputs written once; partner and dt
            # (B, W), the three (B,) scalars
            4 * bw * d * x.element_size() + 2 * bw * 4 + 3 * N_WORLDS * 4,
            FLOPS_PER_ELEM, err),
        "channel_gossip_worlds": (
            lambda: k.channel_gossip_worlds(x, xt_run, xp, corrupt, mscale,
                                            dt, *pw),
            lambda: channel_event_worlds(x, xt, xp, corrupt, mscale, dt,
                                         *pw, backend="ref"),
            # x, xp, x~ read once, two outputs written once; corrupt,
            # mscale, dt (B, W), the three (B,) scalars
            5 * bw * d * x.element_size() + 3 * bw * 4 + 3 * N_WORLDS * 4,
            CHANNEL_FLOPS_PER_ELEM, cerr),
    }
    for name, (kern, plain, nbytes, fpe, e) in runs.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        b = bound(nbytes, fpe * bw * d)
        print(f"[{card}] {name} ({N_WORLDS}, {N_WORKERS}, {d}) f32: "
              f"{ms:.4f} ms over 20 launches, bound {b['bound_ms']:.4f} ms "
              f"({nbytes / 1e9:.3f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} "
              f"TB/s; ops bound {b['ops_ms']:.4f} ms), "
              f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved, plain "
              f"version {plain_ms:.4f} ms; no single PyTorch call computes "
              f"this function (library_ms null)")
        rows[name] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                      "library_ms": None}
    return rows


# --------------------------------------------------------- worlds slices
def worlds_states(sim, params0, seed):
    """B world states at consensus, each with its own generator."""
    dev = torch.device("cuda")
    return sim.batch_states(
        sim.init(params0, N_WORKERS,
                 torch.Generator(device=dev).manual_seed(seed + b))
        for b in range(N_WORLDS))


def worlds_comm_steps(scheds) -> int:
    from repro_torch.core import coalesce_schedule, stack_streams
    bs = stack_streams([coalesce_schedule(s) for s in scheds],
                       np.zeros((len(scheds), N_WORKERS), np.float32))
    return int((~bs.is_grad).sum())


def print_worlds_breakdown(card, label, timer, wall, rounds, comm_steps,
                           kinds):
    """Per-step means of the CUDA-event spans recorded in one replay."""
    parts = {kd: timer.ms(label, kd) for kd in kinds}
    want = {"grad": N_WORLDS * rounds, "mix": rounds + 1}
    for kd, v in parts.items():
        n = want.get(kd, comm_steps)
        require(len(v) == n, f"{label}: timed {len(v)} {kd} calls, "
                             f"expected {n}")
    rest = (wall - sum(sum(v) for v in parts.values())) / rounds
    grads = np.reshape(parts["grad"], (rounds, N_WORLDS)).mean(axis=0)
    desc = ", ".join(f"{kd} {np.mean(v):.4f} ms x {len(v)}"
                     for kd, v in parts.items() if kd != "grad")
    print(f"[{card}] {label} step breakdown (CUDA events in the replay): "
          f"gradient tick per world (16 workers x {BATCH}) "
          f"{[round(float(g), 2) for g in grads]} ms, {desc}; rest per "
          f"round (pack, update, metrics, ring, defense, host) {rest:.2f} "
          f"ms; replay {wall:.1f} ms over {rounds} rounds")


def phase_worlds_slice(card, params0, cfg, stream_cls, grad_fn_for):
    from repro_torch.core import (Algorithm, FlatGossipEngine, Simulator,
                                  World, WorldSweep, params_from_graph,
                                  ring_graph)
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    sweep = WorldSweep.over(World(topology=graph),
                            algorithm=(Algorithm("adpsgd"),
                                       Algorithm("a2cid2")),
                            comms_per_grad=(1.0, 2.0))
    scheds = sweep.compile(ROUNDS)
    worlds = [w for w, _ in sweep.points()]
    comm_steps = worlds_comm_steps(scheds)
    timer = ReplayTimer()
    timer.arm = "clean worlds"
    sim = Simulator(timer.wrap("grad", grad_fn_for(
        cfg, stream_cls(batch_size=BATCH))), params_from_graph(graph, True),
        GAMMA)
    orig = {k: FlatGossipEngine.__dict__[k] for k in ("batch_worlds",
                                                      "mix_batch")}
    states = worlds_states(sim, params0, SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FlatGossipEngine.batch_worlds = staticmethod(
        timer.wrap("comm", FlatGossipEngine.batch_worlds))
    FlatGossipEngine.mix_batch = timer.wrap("mix", orig["mix_batch"])
    reset_launches()
    try:
        t0 = time.perf_counter()
        final, trace = sim.run_worlds(states, scheds, worlds=worlds)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for k, v in orig.items():
            setattr(FlatGossipEngine, k, v)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del states, final
    require(launches["mixing_gossip_worlds"] == comm_steps,
            f"clean worlds kernel launched "
            f"{launches['mixing_gossip_worlds']} times, the batched stream "
            f"has {comm_steps} comm steps")
    require(only_launched(launches, "mixing_gossip_worlds"),
            f"another kernel launched on the clean worlds path: {launches}")
    require(trace.loss.shape == (N_WORLDS, ROUNDS)
            and bool(torch.isfinite(trace.loss).all())
            and bool(torch.isfinite(trace.consensus).all()),
            "clean worlds: non-finite or misshapen trace")
    for b, w in enumerate(worlds):
        print(f"[{card}] world {b} ({w.algorithm.kind}, comms/grad "
              f"{w.comms_per_grad:g}): loss {trace.loss[b].tolist()} "
              f"consensus {trace.consensus[b].tolist()}")
    print(f"[{card}] clean worlds slice: B={N_WORLDS} worlds, "
          f"{comm_steps} shared comm steps + {ROUNDS} gradient ticks; "
          f"mixing_gossip_worlds launches {launches['mixing_gossip_worlds']}"
          f" == {comm_steps}, other kernels 0; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print_worlds_breakdown(card, "clean worlds", timer, wall, ROUNDS,
                           comm_steps, ("grad", "comm", "mix"))
    return launches["mixing_gossip_worlds"]


def phase_channel_worlds_slice(card, params0, cfg, stream_cls, grad_fn_for):
    from repro_torch.core import (AdaptiveDefense, Algorithm,
                                  FlatGossipEngine, Simulator, World,
                                  params_from_graph, ring_graph)
    from repro_torch.core import engine as engine_mod
    graph = ring_graph(N_WORKERS)
    base = World(topology=graph, channel=hostile_channel(graph))
    # arms: {static trim, self-healing defense} x {adpsgd, a2cid2}
    worlds = [dataclasses.replace(base, algorithm=Algorithm(kind))
              for _ in range(2) for kind in ("adpsgd", "a2cid2")]
    defenses = [None, None, AdaptiveDefense(), AdaptiveDefense()]
    scheds = [w.compile(CHANNEL_ROUNDS, seed=CHANNEL_SEED) for w in worlds]
    comm_steps = worlds_comm_steps(scheds)
    timer = ReplayTimer()
    timer.arm = "channel worlds"
    sim = Simulator(timer.wrap("grad", grad_fn_for(
        cfg, stream_cls(batch_size=BATCH))), params_from_graph(graph, True),
        GAMMA)
    orig_kernel = engine_mod.channel_event_worlds
    orig = {k: FlatGossipEngine.__dict__[k] for k in (
        "partner_values_worlds", "delta_norms", "mix_batch")}
    states = worlds_states(sim, params0, SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine_mod.channel_event_worlds = timer.wrap("kernel", orig_kernel)
    FlatGossipEngine.partner_values_worlds = staticmethod(timer.wrap(
        "gather", FlatGossipEngine.partner_values_worlds))
    FlatGossipEngine.delta_norms = staticmethod(timer.wrap(
        "norms", FlatGossipEngine.delta_norms))
    FlatGossipEngine.mix_batch = timer.wrap("mix", orig["mix_batch"])
    reset_launches()
    try:
        t0 = time.perf_counter()
        final, trace = sim.run_worlds(states, scheds, worlds=worlds,
                                      robust_clips=[ROBUST_CLIP] * N_WORLDS,
                                      defenses=defenses)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        engine_mod.channel_event_worlds = orig_kernel
        for k, v in orig.items():
            setattr(FlatGossipEngine, k, v)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del states, final
    require(launches["channel_gossip_worlds"] == comm_steps,
            f"channel worlds kernel launched "
            f"{launches['channel_gossip_worlds']} times, the batched stream "
            f"has {comm_steps} comm steps")
    require(only_launched(launches, "channel_gossip_worlds"),
            f"another kernel launched on the channel worlds path: "
            f"{launches}")
    require(trace.loss.shape == (N_WORLDS, CHANNEL_ROUNDS)
            and bool(torch.isfinite(trace.loss).all())
            and bool(torch.isfinite(trace.consensus).all()),
            "channel worlds: non-finite or misshapen trace")
    dtr = trace.defense
    for b, w in enumerate(worlds):
        arm = "defense" if defenses[b] else "static trim"
        acted = float(dtr.rejections[b].sum() + dtr.quarantined[b].sum())
        if defenses[b]:
            require(acted >= 1, f"world {b} ({arm}): the defense rejected "
                                f"and quarantined nothing")
        print(f"[{card}] world {b} ({arm}, {w.algorithm.kind}): loss "
              f"{trace.loss[b].tolist()} consensus "
              f"{trace.consensus[b].tolist()} tau {dtr.tau[b].tolist()} "
              f"rejections {dtr.rejections[b].tolist()} quarantined "
              f"{dtr.quarantined[b].tolist()}")
    print(f"[{card}] channel worlds slice: B={N_WORLDS} worlds in one "
          f"defense-flavour call, {comm_steps} shared comm steps + "
          f"{CHANNEL_ROUNDS} gradient ticks; channel_gossip_worlds "
          f"launches {launches['channel_gossip_worlds']} == {comm_steps}, "
          f"other kernels 0; peak memory {peak / 2**30:.2f} GiB")
    print_worlds_breakdown(card, "channel worlds", timer, wall,
                           CHANNEL_ROUNDS, comm_steps,
                           ("grad", "kernel", "gather", "norms", "mix"))
    return launches["channel_gossip_worlds"]


def phase_worlds_vs_serial(card):
    from repro_torch.core import (AdaptiveDefense, Algorithm, Simulator,
                                  World, params_from_graph, ring_graph)
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    hostile = hostile_channel(graph)
    flavours = {
        "plain": ([None] * 4, None, None),
        "channel": ([hostile, None, hostile, hostile],
                    [ROBUST_CLIP, None, ROBUST_CLIP, 2 * ROBUST_CLIP], None),
        "defense": ([hostile] * 4, [ROBUST_CLIP] * 4,
                    [None, AdaptiveDefense(), None, AdaptiveDefense()]),
    }
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    # optima at scale 0.1 keep honest delta norms under tau (phase 6)
    target = 0.1 * torch.randn(N_WORKERS, 256, generator=gen, device=dev)

    def quad(x, generator, ids):
        return 0.5 * ((x - target[ids]) ** 2).sum(dim=1), x - target[ids]

    sim = Simulator(quad, params_from_graph(graph, True), GAMMA)
    gammas = [GAMMA, 0.5 * GAMMA, GAMMA, 2 * GAMMA]
    for flavour, (chans, clips, defenses) in flavours.items():
        worlds = [World(topology=graph, channel=c,
                        algorithm=Algorithm(("adpsgd", "a2cid2")[b % 2]),
                        comms_per_grad=(1.0, 2.0, 1.5, 1.0)[b])
                  for b, c in enumerate(chans)]
        scheds = [w.compile(20, seed=SEED + 6 + b)
                  for b, w in enumerate(worlds)]

        def states():
            return [sim.init(torch.zeros(256, device=dev), N_WORKERS,
                             torch.Generator(device=dev).manual_seed(b))
                    for b in range(N_WORLDS)]

        final, trace = sim.run_worlds(states(), scheds, worlds=worlds,
                                      gammas=gammas, robust_clips=clips,
                                      defenses=defenses)
        err, counts = 0.0, 0
        for b in range(N_WORLDS):
            tau = None if clips is None else clips[b]
            serial = dataclasses.replace(
                sim, params=worlds[b].algorithm_params(), gamma=gammas[b],
                robust_clip=tau)
            d = None if defenses is None else defenses[b]
            sf, st = serial.run_schedule(states()[b], scheds[b], defense=d)
            for a, c in ((trace.loss[b], st.loss),
                         (trace.consensus[b], st.consensus),
                         (final.x[b], sf.x), (final.x_tilde[b], sf.x_tilde)):
                torch.testing.assert_close(a, c, rtol=ENGINE_TOL, atol=1e-6)
            err = max(err, (final.x[b] - sf.x).abs().max().item())
            if d is not None:
                require(torch.equal(trace.defense.rejections[b],
                                    st.defense.rejections)
                        and torch.equal(trace.defense.quarantined[b],
                                        st.defense.quarantined),
                        f"{flavour} world {b}: defense counts differ")
                counts += int(st.defense.rejections.sum()
                              + st.defense.quarantined.sum())
        extra = f"; defense counts equal exactly ({counts} acts)" \
            if defenses else ""
        print(f"[{card}] worlds vs serial, {flavour}: B={N_WORLDS} worlds "
              f"(quadratic n=16 d=256, 20 rounds, mixed adpsgd/a2cid2, "
              f"ragged comms/grad) max abs err {err:.3e} (tolerance "
              f"{ENGINE_TOL:g}){extra}")


# ---------------------------------------------------- flash attention kernel
def live_pairs(s_len, t_len, causal, window, dev) -> int:
    from repro_torch.kernels.flash_attention.ref import attention_mask
    return int(attention_mask(s_len, t_len, causal=causal, window=window,
                              device=dev).sum())


def library_attention(q, k, v, causal, window):
    """One PyTorch call computing the same function (timed, never used by
    the port): SDPA on the (1, BH, S, hd) view, causal or with the boolean
    mask of a window."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import attention_mask
    mask = None
    if window is not None:
        mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                              window=window, device=q.device)
    return F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask,
        is_causal=causal and window is None)[0]


def phase_flash_kernel(card):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bhsd
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         attention_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    shapes = [  # (label, BH, S, T, hd, dtype, causal, window)
        ("nano-lm prefill", 96, 1024, 1024, 64, torch.float32, True, None),
        ("Qwen3-0.6B prefill", 32, 4096, 4096, 128, torch.float32, True,
         None),
        ("window 256, unaligned", 96, 1000, 1000, 64, torch.float32, True,
         256),
        ("cross, no mask", 2, 130, 384, 64, torch.float32, False, None),
        ("nano-lm prefill bf16", 96, 1024, 1024, 64, torch.bfloat16, True,
         None),
    ]
    rows = {}
    for label, bh, s_len, t_len, hd, dtype, causal, window in shapes:
        q, k, v = (torch.randn(bh, n, hd, generator=gen, device=dev)
                   .to(dtype) for n in (s_len, t_len, t_len))
        kw = dict(causal=causal, window=window)
        out = flash_attention_bhsd(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        live = attention_mask(s_len, t_len, device=dev, **kw).any(1)
        require(bool(live.all()), f"{label}: every row has a live column")
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            ok = torch.allclose(out, ref, **FLASH_F32_TOL)
            tol = (f"atol {FLASH_F32_TOL['atol']:g}, rtol "
                   f"{FLASH_F32_TOL['rtol']:g}")
        else:
            ok = err <= FLASH_BF16_ATOL
            tol = f"atol {FLASH_BF16_ATOL:g}"
        require(ok, f"flash kernel disagrees with plain at {label}: {err}")
        del out, ref
        ms = cuda_ms(lambda: flash_attention_bhsd(q, k, v, **kw), reps=20)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), reps=5,
                           warmup=1)
        lib_ms = cuda_ms(lambda: library_attention(q, k, v, causal, window),
                         reps=20)
        pairs = bh * live_pairs(s_len, t_len, causal, window, dev)
        flops = 4 * hd * pairs
        nbytes = (2 * s_len + 2 * t_len) * bh * hd * q.element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        b = bound(nbytes, flops, peak)
        print(f"[{card}] flash_attention_bhsd {label} ({bh}, {s_len}, "
              f"{hd}) T={t_len} {str(dtype)[6:]} causal={causal} "
              f"window={window}: max abs err {err:.3e} ({tol}); "
              f"{ms:.4f} ms (mean of 20), bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({flops / 1e9:.2f} GFLOP at "
              f"{peak / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), {flops / ms / 1e9:.2f} "
              f"TFLOP/s achieved ({b['bound_ms'] / ms:.1%} of the bound); "
              f"plain {plain_ms:.4f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms")
        rows[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                       "library_ms": lib_ms}
        del q, k, v
    # a window without the causal mask: rows 163.. see no column; the
    # kernel writes 0 there (the plain version the mean of v)
    q, k, v = (torch.randn(2, n, 64, generator=gen, device=dev)
               for n in (200, 100, 100))
    out = flash_attention_bhsd(q, k, v, causal=False, window=64)
    ref = attention_ref(q, k, v, causal=False, window=64)
    live = attention_mask(200, 100, causal=False, window=64,
                          device=dev).any(1)
    require(int((~live).sum()) == 37 and bool((out[:, ~live] == 0).all()),
            "rows with no live column are not exactly 0")
    require(torch.allclose(out[:, live], ref[:, live], **FLASH_F32_TOL),
            "flash kernel disagrees with plain on the live rows of the "
            "windowed cross shape")
    print(f"[{card}] flash_attention_bhsd identity: the 37 rows with no "
          f"live column (window 64, no causal mask, S=200, T=100) are "
          f"exactly 0; live rows within tolerance")
    return rows


# --------------------------------------------------------- rmsnorm kernel
def phase_rmsnorm_kernel(card):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_2d
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = {}
    for t, d, dtype in ((8192, 768, torch.float32),
                        (8192, 768, torch.bfloat16),
                        (8192, 1024, torch.float32),
                        (8192, 1024, torch.bfloat16),
                        (130, 768, torch.float32), (1, 256, torch.float32)):
        x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
        sc = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        out, ref = rmsnorm_2d(x, sc), rmsnorm_ref(x, sc)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = RMSNORM_F32_ATOL if dtype == torch.float32 \
            else RMSNORM_BF16_ATOL
        require(err <= tol, f"rmsnorm_2d disagrees with plain at ({t}, {d})"
                            f" {dtype}: {err}")
        ms = cuda_ms(lambda: rmsnorm_2d(x, sc), reps=20)
        plain_ms = cuda_ms(lambda: rmsnorm_ref(x, sc), reps=20)
        weight = 1 + sc
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight, 1e-6), reps=20)
        nbytes = (2 * t * d + d) * x.element_size()
        b = bound(nbytes, 4 * t * d,
                  PEAK_F32_FLOPS if dtype == torch.float32
                  else PEAK_BF16_FLOPS)
        print(f"[{card}] rmsnorm_2d ({t}, {d}) {str(dtype)[6:]}: max abs err "
              f"{err:.3e} (atol {tol:g}); {ms:.4f} ms (mean of 20), bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({nbytes / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} "
              f"TB/s), {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved "
              f"({b['bound_ms'] / ms:.1%} of the bound); plain "
              f"{plain_ms:.4f} ms; F.rms_norm {lib_ms:.4f} ms")
        rows[(t, d, dtype)] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms,
                               "bound_ms": b["bound_ms"],
                               "bound_by": b["bound_by"],
                               "library_ms": lib_ms}
    return rows[(8192, 768, torch.float32)]


# ------------------------------------------------ (A) the LM gossip replay
def phase_lm_replay(card):
    """(A): nano-lm full through ``run_sim``, baseline and A2CiD2 arms.
    Returns (launches of the clean kernel, the model config, the stream,
    the A2CiD2 arm's consensus model)."""
    from repro_torch.core import (FlatGossipEngine, coalesce_schedule,
                                  coalesced_stream, make_schedule,
                                  ring_graph, worker_mean)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import LMTaskStream
    from repro_torch.launch import train
    dev = torch.device("cuda")
    argv = ["--full", "--arch", "nano-lm", "--workers", str(LM_WORKERS),
            "--steps", str(LM_ROUNDS), "--no-bayes-ce"]
    base = train.build_parser().parse_args(argv)
    cfg, _ = train.build_model(base.arch, reduced=not base.full)
    t0 = time.perf_counter()
    stream = LMTaskStream(vocab_size=cfg.vocab_size, seq_len=base.seq_len,
                          batch_size=base.batch_size, seed=base.seed)
    stream.sample(torch.Generator(device=dev))   # draws the (V, V) chain
    torch.cuda.synchronize()
    print(f"[{card}] LMTaskStream V={cfg.vocab_size}: transition logits "
          f"drawn (numpy) and moved to the card in "
          f"{time.perf_counter() - t0:.1f} s")
    sched = make_schedule(ring_graph(LM_WORKERS), LM_ROUNDS,
                          comms_per_grad=base.comms_per_grad,
                          seed=base.seed)
    steps = coalesced_stream(coalesce_schedule(sched),
                             np.zeros(LM_WORKERS, np.float32))
    comm_steps = int((~steps.is_grad).sum())
    timer = ReplayTimer()
    orig_grad_fn, orig_batch = train.lm_grad_fn, FlatGossipEngine.batch
    train.lm_grad_fn = lambda m, s: timer.wrap("grad", orig_grad_fn(m, s))
    FlatGossipEngine.batch = timer.wrap("comm", orig_batch)
    runs, peaks = {}, {}
    reset_launches()
    try:
        for arm, acid in (("baseline", False), ("a2cid2", True)):
            timer.arm = arm
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs[arm] = train.run_sim(
                train.build_parser().parse_args(
                    argv + (["--acid"] if acid else [])), stream=stream)
            peaks[arm] = torch.cuda.max_memory_allocated()
            if arm == "baseline":
                runs[arm] = runs[arm]._replace(state=None)
    finally:
        train.lm_grad_fn, FlatGossipEngine.batch = orig_grad_fn, orig_batch
    launches = read_launches()
    n_params = sum(a[0].numel() for a in tree_leaves(runs["a2cid2"].state.x))
    require(n_params == NANO_PARAMS,
            f"nano-lm has {n_params} parameters, JAX's eval_shape "
            f"{NANO_PARAMS}")
    require(launches["mixing_gossip_stacked"] == 2 * comm_steps,
            f"clean kernel launched {launches['mixing_gossip_stacked']} "
            f"times, stream has {comm_steps} comm steps per arm")
    require(only_launched(launches, "mixing_gossip_stacked"),
            f"another kernel launched on the LM replay: {launches}")
    for arm, run in runs.items():
        tr = run.trace
        require(tr.loss.shape == (LM_ROUNDS,)
                and bool(torch.isfinite(tr.loss).all())
                and bool(torch.isfinite(tr.consensus).all()),
                f"LM {arm}: non-finite or misshapen trace")
        comm, grad = timer.ms(arm, "comm"), timer.ms(arm, "grad")
        require(len(comm) == comm_steps and len(grad) == LM_ROUNDS,
                f"LM {arm}: timed {len(comm)} comm batches and {len(grad)} "
                f"gradient ticks")
        wall = run.seconds * 1e3
        rest = (wall - sum(comm) - sum(grad)) / LM_ROUNDS
        print(f"[{card}] LM {arm}: loss {tr.loss.tolist()} consensus "
              f"{tr.consensus.tolist()}; replay {wall:.1f} ms: model tick "
              f"({LM_WORKERS} workers x {base.batch_size} x {base.seq_len} "
              f"tokens) {np.mean(grad):.2f} ms x {LM_ROUNDS} "
              f"{[round(t, 2) for t in grad]} ({sum(grad) / wall:.1%}), "
              f"comm batch {np.mean(comm):.4f} ms x {comm_steps} "
              f"{[round(t, 4) for t in comm]}, rest per round (pack, "
              f"update, metrics, mix, host) {rest:.2f} ms; peak memory "
              f"{peaks[arm] / 2**30:.2f} GiB")
    print(f"[{card}] LM replay: nano-lm full, {n_params} parameters, "
          f"{comm_steps} comm steps + {LM_ROUNDS} gradient ticks per arm; "
          f"mixing_gossip_stacked launches "
          f"{launches['mixing_gossip_stacked']} == 2 x {comm_steps}, every "
          f"other kernel 0")
    acid = runs["a2cid2"]
    return (launches["mixing_gossip_stacked"], acid.model.cfg, acid.stream,
            worker_mean(acid.state.x))


def phase_lm_engine_vs_reference(card, cfg, stream):
    """The engine against the per-event replay on the LM of (A), 3 rounds at
    1.5 comms per gradient (seed 1 puts two comm batches between every two
    gradient ticks)."""
    from repro_torch.core import (Simulator, make_schedule,
                                  params_from_graph, ring_graph)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.transformer import Model, lm_grad_fn
    dev = torch.device("cuda")
    model = Model(cfg)
    graph = ring_graph(LM_WORKERS)
    sim = Simulator(lm_grad_fn(model, stream),
                    params_from_graph(graph, True), 0.05, device=dev)
    params0 = model.init(torch.Generator(device=dev).manual_seed(SEED))
    sched = make_schedule(graph, 3, comms_per_grad=1.5, seed=SEED + 1)

    def state():
        return sim.init(params0, LM_WORKERS,
                        torch.Generator(device=dev).manual_seed(SEED + 1))

    ef, et = sim.run_schedule(state(), sched)
    rf, rt = sim.run_schedule(state(), sched, engine=False)
    err = 0.0
    for a, c in ((et.loss, rt.loss), (et.consensus, rt.consensus),
                 *zip(tree_leaves(ef.x), tree_leaves(rf.x)),
                 *zip(tree_leaves(ef.x_tilde), tree_leaves(rf.x_tilde))):
        torch.testing.assert_close(a, c, rtol=ENGINE_TOL, atol=1e-6)
        err = max(err, (a - c).abs().max().item())
    print(f"[{card}] LM engine vs per-event replay ({cfg.name}, "
          f"{cfg.num_layers} layers, {LM_WORKERS} workers, 3 rounds at 1.5 "
          f"comms/grad): losses {et.loss.tolist()}, max abs err {err:.3e} "
          f"(rtol {ENGINE_TOL:g}, atol 1e-6)")


# ------------------------------------------ (B) prefill with flash attention
def check_prefill(card, label, cfg, params, tokens, n_attn):
    """Pallas vs xla prefill of one model on ``tokens`` (B, S+1): the flash
    launches of one forward, the logits' agreement, the CE; returns the
    flash launches."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import Model
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    batch = {"inputs": inputs}
    pallas = make_prefill_step(Model(cfg.with_updates(
        attention_impl="pallas")))
    xla = make_prefill_step(Model(cfg.with_updates(attention_impl="xla")))
    pallas(params, batch)                      # warm-up, not counted
    timer = ReplayTimer()
    timer.arm = label
    orig = flash_ops.flash_attention_bhsd
    flash_ops.flash_attention_bhsd = timer.wrap("flash", orig)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches()
    try:
        start.record()
        logits = pallas(params, batch)
        end.record()
        torch.cuda.synchronize()
    finally:
        flash_ops.flash_attention_bhsd = orig
    launches = read_launches()
    fwd_ms = start.elapsed_time(end)
    flash = timer.ms(label, "flash")
    require(launches["flash_attention_bhsd"] == n_attn,
            f"{label}: flash launched {launches['flash_attention_bhsd']} "
            f"times, the model has {n_attn} attention layers")
    require(only_launched(launches, "flash_attention_bhsd"),
            f"{label}: another kernel launched in the prefill: {launches}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = xla(params, batch)
    torch.cuda.synchronize()
    xla_ms = (time.perf_counter() - t0) * 1e3
    scale = ref.abs().max().item()
    rel = (logits - ref).abs().max().item() / scale
    require(rel < MODEL_TOL, f"{label}: pallas vs xla logits "
                             f"max|d|/max|logit| = {rel:.3e}")
    v = cfg.padded_vocab
    ce = F.cross_entropy(logits.reshape(-1, v).float(),
                         labels.reshape(-1)).item()
    require(np.isfinite(ce), f"{label}: CE is not finite")
    b, s = inputs.shape
    print(f"[{card}] prefill {label} (B={b}, S={s}): flash launches "
          f"{launches['flash_attention_bhsd']} == {n_attn} attention layers,"
          f" other kernels 0; logits vs the xla path max|d|/max|logit| "
          f"{rel:.3e} (< {MODEL_TOL:g}); CE {ce:.4f}; forward "
          f"{fwd_ms:.2f} ms (CUDA events), flash kernel {sum(flash):.2f} ms"
          f" over {len(flash)} launches ({sum(flash) / fwd_ms:.1%} of the "
          f"forward); the xla forward {xla_ms:.2f} ms (host clock)")
    return launches["flash_attention_bhsd"]


def phase_prefill(card, nano, consensus, stream):
    """(B) on the consensus model of (A) and on Qwen3-0.6B; returns the
    flash launches of the two forwards."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    dev = torch.device("cuda")
    held_out = stream.reshaped(seq_len=1024, batch_size=8)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    toks = held_out.sample(gen)
    tokens = torch.cat([toks["inputs"], toks["labels"][:, -1:]], dim=1)
    launches = check_prefill(card, "nano-lm consensus model", nano,
                             consensus, tokens, nano.num_layers)
    del consensus, held_out
    torch.cuda.empty_cache()
    qwen = get_config("qwen3-0.6b")
    model = Model(qwen)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = model.param_count(params)
    require(n_params == QWEN_PARAMS, f"Qwen3-0.6B has {n_params} "
                                     f"parameters, JAX's {QWEN_PARAMS}")
    tokens = torch.randint(0, qwen.vocab_size, (2, 4096 + 1),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    launches += check_prefill(card, "Qwen3-0.6B", qwen, params, tokens,
                              qwen.num_layers)
    print(f"[{card}] Qwen3-0.6B: {n_params} parameters (random, seed 0), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


# ----------------------------------------- 15: the per-worker event kernel
def check_p2p(card, dyn, d, d_real, dtype, gen):
    """``p2p_mixing`` against its plain version at (d,) bit for bit, x~ in
    place beside a fresh out_x, and the identities; returns the inputs."""
    from repro_torch.kernels.a2cid2_mixing.kernel import p2p_mixing
    from repro_torch.kernels.a2cid2_mixing.ops import p2p_mix_event
    dev = torch.device("cuda")
    x, xt, xp = (torch.randn(d, generator=gen, device=dev).to(dtype)
                 for _ in range(3))
    for v in (x, xt, xp):
        v[d_real:] = 0
    # the event gaps of a step on the card; the kernel reads dts[1]
    dts = torch.rand(3, generator=gen, device=dev) * 1.5
    rx, rxt = p2p_mix_event(x, xt, xp, dts[1], backend="ref", **dyn)
    kxt_in = xt.clone()
    kx, kxt = p2p_mixing(x, kxt_in, xp, dts[1], **dyn)
    torch.cuda.synchronize()
    err = max((kx.float() - rx.float()).abs().max().item(),
              (kxt.float() - rxt.float()).abs().max().item())
    require(err == 0.0 and torch.equal(kx, rx) and torch.equal(kxt, rxt),
            f"p2p_mixing {dtype} differs from its plain version: {err}")
    require(kxt.data_ptr() == kxt_in.data_ptr()
            and kx.data_ptr() not in (x.data_ptr(), xt.data_ptr()),
            "p2p_mixing must write x~ in place and a fresh out_x")
    require(bool((kx[d_real:] == 0).all() and (kxt[d_real:] == 0).all()),
            "p2p_mixing: padding columns did not stay 0")
    # xp = x with eta = 0: a no-op; alpha = alpha~ = 0: a pure mixing step
    nx, nxt = p2p_mixing(x, xt.clone(), x, dts[0], eta=0.0, alpha=0.5,
                         alpha_t=0.5)
    mx, mxt = p2p_mixing(x, xt.clone(), xp, dts[0], eta=dyn["eta"],
                         alpha=0.0, alpha_t=0.0)
    from repro_torch.core.a2cid2 import apply_mixing
    px, pxt = apply_mixing(x, xt, dyn["eta"], dts[0])
    torch.cuda.synchronize()
    require(torch.equal(nx, x) and torch.equal(nxt, xt),
            "p2p_mixing: xp = x with eta = 0 changed the state")
    require(torch.equal(mx, px) and torch.equal(mxt, pxt),
            "p2p_mixing: alpha = alpha~ = 0 is not the pure mixing step")
    print(f"[{card}] p2p_mixing vs plain {dtype} ({d},): max abs err "
          f"{err:.1e} (bit for bit); x~ in place, out_x fresh; exact: xp = "
          f"x with eta 0 a no-op, alpha = alpha~ = 0 the mixing step, "
          f"{d - d_real} padding columns 0")
    return err, (x, xt, xp, dts)


def phase_p2p_kernel(card, d, d_real, dyn):
    """15: ``p2p_mixing`` at ResNet-18-CIFAR's padded width, f32 and bf16,
    each row bit for bit what ``mixing_gossip_stacked`` computes for it."""
    from repro_torch.kernels.a2cid2_mixing.kernel import (
        mixing_gossip_stacked, p2p_mixing)
    from repro_torch.kernels.a2cid2_mixing.ops import p2p_mix_event
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    err_bf16, (bx, bxt, bxp, bdts) = check_p2p(card, dyn, d, d_real,
                                               torch.bfloat16, gen)
    bf16_ms = cuda_ms(lambda: p2p_mixing(bx, bxt, bxp, bdts[1], **dyn),
                      reps=20)
    bf16_graph_ms, _ = graph_ms(lambda: p2p_mixing(bx, bxt, bxp, bdts[1],
                                                   **dyn), 20)
    del bx, bxt, bxp
    err, (x, xt, xp, dts) = check_p2p(card, dyn, d, d_real, torch.float32,
                                      gen)
    # per row, the stacked kernel of 4 workers (two pairs) bit for bit
    w = 4
    sx = torch.randn(w, d, generator=gen, device="cuda")
    sxt = torch.randn(w, d, generator=gen, device="cuda")
    partner = torch.tensor([1, 0, 3, 2], dtype=torch.int32, device="cuda")
    dt_w = dts[1].expand(w).contiguous()
    ox, oxt = mixing_gossip_stacked(sx, sxt.clone(), partner, dt_w, **dyn)
    rows = [p2p_mixing(sx[i], sxt[i].clone(), sx[int(partner[i])], dts[1],
                       **dyn) for i in range(w)]
    torch.cuda.synchronize()
    require(all(torch.equal(ox[i], r[0]) and torch.equal(oxt[i], r[1])
                for i, r in enumerate(rows)),
            "p2p_mixing rows differ from mixing_gossip_stacked's")
    del sx, sxt, ox, oxt, rows
    xt_run = xt.clone()
    ms = cuda_ms(lambda: p2p_mixing(x, xt_run, xp, dts[1], **dyn), reps=20)
    plain_ms = cuda_ms(lambda: p2p_mix_event(x, xt, xp, dts[1],
                                             backend="ref", **dyn),
                       reps=5, warmup=1)
    # x, x~ and xp read once, two outputs written once, dt read once
    nbytes = 5 * d * x.element_size() + 4
    b = bound(nbytes, FLOPS_PER_ELEM * d)
    b16 = bound(5 * d * 2 + 4, FLOPS_PER_ELEM * d)
    print(f"[{card}] p2p_mixing rows equal mixing_gossip_stacked's bit for "
          f"bit (4 workers, two pairs)")
    print(f"[{card}] p2p_mixing ({d},) f32: {ms:.4f} ms over 20 launches, "
          f"bound {b['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; ops bound "
          f"{b['ops_ms']:.4f} ms), {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s "
          f"achieved ({b['bound_ms'] / ms:.1%} of the bound); bf16 "
          f"{bf16_ms:.4f} ms ({bf16_graph_ms:.4f} ms a launch of 20 in a "
          f"CUDA graph) against {b16['bound_ms']:.4f} ms; plain version "
          f"{plain_ms:.4f} ms; no single PyTorch call computes this "
          f"two-output update (library_ms null)")
    return {"max_abs_err": max(err, err_bf16), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def phase_channel_local(card, d, d_real, dyn):
    """15, continued: ``channel_event_local`` (``channel_gossip_stacked`` on
    a (1, D) view, the SPMD channel path's shape) against its plain version
    at (d,), f32 and bf16, bit for bit, over corrupt offsets, robust scales
    in [0, 1] and the coordinate clip, with 0-dim card scalars as
    ``engine.channel_batch_local`` passes them.  Returns the largest
    error."""
    from repro_torch.kernels.a2cid2_mixing.ops import channel_event_local
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    cases = [(c, s, clip) for c, s in ((0.0, 1.0), (999.0, 1.0),
                                       (-2.0, 0.25), (999.0, 0.0))
             for clip in (None, 0.3)]
    err, ms = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        x, xt, xp = (torch.randn(d, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        for v in (x, xt, xp):
            v[d_real:] = 0
        dt = torch.rand((), generator=gen, device=dev) * 1.5
        for corrupt, mscale, clip in cases:
            c, s = (torch.tensor(v, device=dev) for v in (corrupt, mscale))
            rx, rxt = channel_event_local(x, xt, xp, c, s, dt, clip=clip,
                                          backend="ref", **dyn)
            kxt_in = xt.clone()
            kx, kxt = channel_event_local(x, kxt_in, xp, c, s, dt,
                                          clip=clip, **dyn)
            torch.cuda.synchronize()
            e = max((kx.float() - rx.float()).abs().max().item(),
                    (kxt.float() - rxt.float()).abs().max().item())
            err = max(err, e)
            require(torch.equal(kx, rx) and torch.equal(kxt, rxt)
                    and kx.shape == x.shape
                    and kxt.data_ptr() == kxt_in.data_ptr(),
                    f"channel_event_local {dtype} corrupt {corrupt} mscale "
                    f"{mscale} clip {clip} differs from its plain version "
                    f"({e}) or did not update x~ in place")
        if dtype == torch.float32:
            c, s = torch.tensor(999.0, device=dev), torch.tensor(0.25,
                                                                 device=dev)
            ms = cuda_ms(lambda: channel_event_local(x, xt, xp, c, s, dt,
                                                     **dyn), reps=20)
    nbytes = 5 * d * 4 + 12
    print(f"[{card}] channel_event_local ((1, D) channel_gossip_stacked) vs "
          f"plain at ({d},) f32 and bf16, corrupt 0 / 999 / -2, mscale 1 / "
          f"0.25 / 0, clip none / 0.3 ({len(cases)} cases each): max abs err "
          f"{err:.1e} (bit for bit), x~ in place; f32 {ms:.4f} ms a launch "
          f"over 20, bound {bound(nbytes, 0)['bound_ms']:.4f} ms")
    return err


# -------------------------------------------- 16: the per-leaf event API
def phase_mixing_p2p(card, params0, dyn):
    """16: ``mixing_p2p`` through ``gossip_event_pytree`` on every leaf of
    the ResNet-18-CIFAR tree, f32 and bf16, bit for bit its plain version,
    plus odd lengths and misaligned views.  Returns (the row, the launches
    of the main-path call)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.a2cid2_mixing.kernel import mixing_p2p
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_pytree
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def perturbed(tree):
        return tree_map(lambda a: a + 0.1 * torch.randn(
            a.shape, generator=gen, device=a.device), tree)

    x, xt, xp = params0, perturbed(params0), perturbed(params0)
    leaves = tree_leaves(x)
    n = sum(a.numel() for a in leaves)
    dt = torch.tensor(0.37, device="cuda")
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        trees = [tree_map(lambda a: a.to(dtype), t) for t in (x, xt, xp)]
        ref = gossip_event_pytree(*trees, dt, backend="ref", **dyn)
        got = gossip_event_pytree(*trees, dt, **dyn)
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            for a, b in zip(tree_leaves(r), tree_leaves(g)):
                err = max(err, (a.float() - b.float()).abs().max().item())
                require(torch.equal(a, b), f"mixing_p2p {dtype} differs "
                                           f"from its plain version")
    # odd lengths, and views 1 and 3 elements past an aligned start
    for length, off in ODD_LEAVES:
        for dtype in (torch.float32, torch.bfloat16):
            base = [torch.randn(length + 8, generator=gen,
                                device="cuda").to(dtype) for _ in range(3)]
            args = [v[off:off + length] for v in base]
            r = gossip_event_pytree(*args, dt, backend="ref", **dyn)
            g = mixing_p2p(*args, dt, **dyn)
            torch.cuda.synchronize()
            require(torch.equal(r[0], g[0]) and torch.equal(r[1], g[1]),
                    f"mixing_p2p ({length},) at offset {off} {dtype} "
                    f"differs from its plain version")
    print(f"[{card}] mixing_p2p vs plain on the {len(leaves)} leaves of "
          f"the ResNet tree ({n} parameters, "
          f"{min(a.numel() for a in leaves)} to "
          f"{max(a.numel() for a in leaves)} a leaf) f32 and bf16: max abs "
          f"err {err:.1e} (bit for bit); odd lengths and views at element "
          f"offsets 1 and 3 ({ODD_LEAVES}), f32 and bf16: bit for bit")
    reset_launches()
    gossip_event_pytree(x, xt, xp, dt, **dyn)     # the main-path call
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches["mixing_p2p"] == len(leaves)
            and only_launched(launches, "mixing_p2p"),
            f"gossip_event_pytree launched {launches}, want "
            f"{len(leaves)} mixing_p2p and nothing else")
    ms = cuda_ms(lambda: gossip_event_pytree(x, xt, xp, dt, **dyn), reps=20)
    plain_ms = cuda_ms(lambda: gossip_event_pytree(x, xt, xp, dt,
                                                   backend="ref", **dyn),
                       reps=5, warmup=1)
    # per leaf: x, x~, xp read once, two outputs written once, dt once
    nbytes = 5 * n * 4 + 4 * len(leaves)
    b = bound(nbytes, FLOPS_PER_ELEM * n)
    # the host taken out (CUDA graphs): the kernel alone, 20 launches on
    # the largest leaf against its own bound, and the tree's 56 launches
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    lx, lxt, lxp = (tree_leaves(t)[big] for t in (x, xt, xp))
    eager_leaf_ms = cuda_ms(lambda: mixing_p2p(lx, lxt, lxp, dt, **dyn),
                            reps=20)
    leaf_ms, _ = graph_ms(lambda: mixing_p2p(lx, lxt, lxp, dt, **dyn), 20)
    lb = bound(5 * lx.numel() * 4 + 4, FLOPS_PER_ELEM * lx.numel())
    want = gossip_event_pytree(x, xt, xp, dt, **dyn)
    tree_ms, got = graph_ms(lambda: gossip_event_pytree(x, xt, xp, dt,
                                                        **dyn), 1)
    torch.cuda.synchronize()
    require(all(torch.equal(a, g) for r, o in zip(want, got)
                for a, g in zip(tree_leaves(r), tree_leaves(o))),
            "mixing_p2p: the graph-captured tree differs from the eager one")
    del got, want
    print(f"[{card}] gossip_event_pytree on the ResNet tree f32: "
          f"{launches['mixing_p2p']} mixing_p2p launches and nothing else; "
          f"{ms:.4f} ms a tree (20 trees, {ms / len(leaves) * 1e3:.2f} us a "
          f"launch), summed bound {b['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.1f} MB), plain version {plain_ms:.4f} ms; "
          f"library_ms null")
    print(f"[{card}] mixing_p2p alone on the largest leaf ({lx.numel()},) "
          f"f32, 20 launches in a CUDA graph: {leaf_ms:.4f} ms a launch, "
          f"bound {lb['bound_ms']:.4f} ms ({lb['bound_ms'] / leaf_ms:.1%}); "
          f"issued eagerly {eager_leaf_ms:.4f} ms a launch; the tree's "
          f"{len(leaves)} launches as one CUDA graph (bit for bit the eager "
          f"tree): {tree_ms:.4f} ms a tree over 10 "
          f"({tree_ms / len(leaves) * 1e3:.2f} us a launch, "
          f"{b['bound_ms'] / tree_ms:.1%} of the summed bound); the host "
          f"is {1 - tree_ms / ms:.1%} of the eager tree")
    return ({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None}, launches["mixing_p2p"])


# ------------------------------------------------ 17, 18: the trainers
TRAIN_STEPS, TRAIN_COMMS, TRAIN_LR = 4, 2, 0.1
# (length, element offset) of the odd leaves of phase 16
ODD_LEAVES = ((10, 0), (127, 0), (1_000_003, 0), (4099, 1), (4099, 3))


def trainer_arms(graph):
    """The arms of phases 17-18: baseline, A2CiD2, and A2CiD2 over a
    channel the mesh trainers model (always-on 1e3 scale on 2 edges, 10%
    drops, stale reads from a ring of 2, trim at tau 5)."""
    from repro_torch.core import ByzantineEdges, ChannelModel, DelayProcess
    picks = np.linspace(0, len(graph.edges), 2, endpoint=False).astype(int)
    chan = ChannelModel(
        delay=DelayProcess(horizon=2, prob=1.0),
        adversary=ByzantineEdges(tuple(graph.edges[i] for i in picks),
                                 "scale", scale=1e3, prob=1.0),
        drop_prob=0.1)
    return {"baseline": dict(accelerated=False),
            "a2cid2": dict(accelerated=True),
            "channel": dict(accelerated=True, channel=chan,
                            robust_clip=ROBUST_CLIP, robust_rule="trim")}


def run_trainer_arm(label, trainer, state, step, batches):
    """One step per batch of one arm, each on its own draws; returns (the
    state, the host-clock ms of each step, the draws, the losses)."""
    walls, draws_all, losses = [], [], []
    for batch in batches:
        draws = trainer.sample_draws(state.generator)
        draws_all.append(draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    require(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    return state, walls, draws_all, losses


def phase_spmd_slice(card, params0, cfg):
    """17: ``GossipTrainer`` on ResNet-18-CIFAR, 16 workers on a ring in
    lockstep over the single-card worker axis; returns the launches of
    p2p_mixing and channel_gossip_stacked."""
    from repro_torch.core import FlatGossipEngine, World, ring_graph
    from repro_torch.core import consensus_distance_spmd
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.launch import gossip_train as gt
    from repro_torch.models.resnet import resnet_loss
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    world = World(topology=graph, comms_per_grad=TRAIN_COMMS)
    stream = SyntheticCIFAR(batch_size=BATCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    batches = [stream.sample_workers(gen, N_WORKERS)
               for _ in range(TRAIN_STEPS)]

    def loss_fn(p, batch):
        return resnet_loss(p, cfg, batch)

    timer = ReplayTimer()
    orig_grad = gt.grad_and_value
    saved = {k: FlatGossipEngine.__dict__[k] for k in
             ("batch_local", "channel_batch_local")}
    gt.grad_and_value = lambda f, **kw: timer.wrap("grad", orig_grad(f,
                                                                     **kw))
    FlatGossipEngine.batch_local = timer.wrap(
        "kernel", saved["batch_local"])
    FlatGossipEngine.channel_batch_local = timer.wrap(
        "kernel", saved["channel_batch_local"])
    out = {"p2p_mixing": 0, "channel_gossip_stacked": 0}
    try:
        for arm, kw in trainer_arms(graph).items():
            trainer = gt.GossipTrainer.from_world(world, loss_fn, sgd(),
                                                  lr=TRAIN_LR, **kw)
            state = trainer.init(params0, torch.Generator().manual_seed(
                SEED + 17))
            step = trainer.make_step()
            if arm == "baseline":   # warm-up, outside the counts (cuDNN)
                timer.arm = "warm-up"
                step(state, batches[0])
            timer.arm = arm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, walls, draws, losses = run_trainer_arm(
                f"SPMD {arm}", trainer, state, step, batches)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            events = TRAIN_STEPS * trainer.comms_per_step
            name = "channel_gossip_stacked" if arm == "channel" \
                else "p2p_mixing"
            require(launches[name] == events * N_WORKERS
                    and only_launched(launches, name),
                    f"SPMD {arm}: launches {launches}, want {name} == "
                    f"{TRAIN_STEPS} x {trainer.comms_per_step} x "
                    f"{N_WORKERS} and nothing else")
            out[name] += launches[name]
            dropped = sum(int((d.idxs < 0).sum()) for d in draws)
            cons = float(consensus_distance_spmd(state.params))
            require(np.isfinite(cons), f"SPMD {arm}: consensus not finite")
            grad, kern = timer.ms(arm, "grad"), timer.ms(arm, "kernel")
            require(len(grad) == TRAIN_STEPS * N_WORKERS
                    and len(kern) == events * N_WORKERS,
                    f"SPMD {arm}: timed {len(grad)} gradients and "
                    f"{len(kern)} kernel calls")
            per_event = [sum(kern[i:i + N_WORKERS])
                         for i in range(0, len(kern), N_WORKERS)]
            rest = (sum(walls) - sum(grad) - sum(kern)) / TRAIN_STEPS
            print(f"[{card}] SPMD {arm}: loss {losses}, consensus {cons:.6g}"
                  f", {dropped} dropped events; {name} launches "
                  f"{launches[name]} == {TRAIN_STEPS} x "
                  f"{trainer.comms_per_step} x {N_WORKERS}, every other "
                  f"kernel 0; peak memory {peak / 2**30:.2f} GiB")
            print(f"[{card}] SPMD {arm} step breakdown (CUDA events in the "
                  f"step): per-worker gradient {np.mean(grad):.2f} ms x "
                  f"{N_WORKERS} a step ({min(grad):.2f}..{max(grad):.2f}), "
                  f"kernel {np.mean(kern):.4f} ms a launch, "
                  f"{np.mean(per_event):.4f} ms an event of {N_WORKERS} "
                  f"launches {[round(t, 4) for t in per_event]}, rest "
                  f"(mix, update, pack, unpack, draws, host) {rest:.2f} ms a "
                  f"step; step {np.mean(walls):.1f} ms "
                  f"{[round(t, 1) for t in walls]}")
            del state
    finally:
        gt.grad_and_value = orig_grad
        for k, v in saved.items():
            setattr(FlatGossipEngine, k, v)
    check_spmd_channel_events(card, graph, params0)
    return out


def check_spmd_channel_events(card, graph, params0):
    """17, continued: whole SPMD channel events of the channel arm's
    channel (Byzantine edges, a dropped event, stale reads from each
    worker's ring), each worker's robust scale computed on the card by
    ``engine.channel_batch_local``, against the same events through the
    plain version, bit for bit, under the trim and the clip rule."""
    import functools
    from repro_torch.core import GossipMixer, params_from_graph
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    # replicas 3e-4 apart: honest deltas (norm ~1.4) stay under tau = 5,
    # the 1e3-scaled reads do not
    xs, xts = ([tree_map(lambda a: a + 3e-4 * torch.randn(
        a.shape, generator=gen, device=dev), params0)
        for _ in range(N_WORKERS)] for _ in range(2))
    chan = trainer_arms(graph)["channel"]["channel"]
    kernel_local = engine_mod.channel_event_local
    for rule in ("trim", "clip"):
        mixer = GossipMixer(graph, params_from_graph(graph, True),
                            channel=chan, robust_clip=ROBUST_CLIP,
                            robust_rule=rule)
        # two pushed rounds, so a stale read comes from the ring
        rings = mixer.push_ring(mixer.push_ring(mixer.init_ring(xs), xs),
                                xts)
        m = mixer.bank.shape[0]
        idxs = np.array(list(range(m)) + [-1], np.int32)
        gaps = torch.linspace(0.2, 0.6, m + 1)
        stale = np.array([1, 0] * m + [0], np.int32)[:m + 1]
        scales = []

        def recording(*args, **kw):
            scales.append(args[4])
            return kernel_local(*args, **kw)

        reset_launches()
        engine_mod.channel_event_local = recording
        try:
            kx, kxt = mixer.gossip_events(xs, xts, idxs, gaps, rings=rings,
                                          stale=stale)
            torch.cuda.synchronize()
            launches = read_launches()
            engine_mod.channel_event_local = functools.partial(
                kernel_local, backend="ref")
            rx, rxt = mixer.gossip_events(xs, xts, idxs, gaps, rings=rings,
                                          stale=stale)
            torch.cuda.synchronize()
        finally:
            engine_mod.channel_event_local = kernel_local
        require(launches["channel_gossip_stacked"] == (m + 1) * N_WORKERS
                and only_launched(launches, "channel_gossip_stacked"),
                f"SPMD channel events ({rule}) launched {launches}")
        require(all(torch.equal(a, b) for k, r in ((kx, rx), (kxt, rxt))
                    for kw, rw in zip(k, r)
                    for a, b in zip(tree_leaves(kw), tree_leaves(rw))),
                f"SPMD channel events ({rule}) differ from the plain version")
        s = torch.stack(scales).float()
        require(bool((s < 1).any() and (s == 1).any()),
                f"SPMD channel events ({rule}): the robust rule never "
                f"engaged, or rejected every read")
        print(f"[{card}] SPMD channel events vs plain ({rule} at tau "
              f"{ROBUST_CLIP:g}, {m} matchings and one dropped event, stale "
              f"reads {stale.tolist()} from rings of 2 rounds, "
              f"{N_WORKERS} workers at full width): bit for bit; "
              f"{launches['channel_gossip_stacked']} (1, D) launches; "
              f"{int((s < 1).sum())} of {s.numel()} reads scaled below 1 "
              f"on the card (min {s.min().item():.3g})")
        del kx, kxt, rx, rxt, rings


def phase_stacked_slice(card, params0, cfg):
    """18: ``StackedGossipTrainer`` on the same model and arms; the SPMD and
    the stacked event loops per row bit for bit; one pair-ring and one AR
    step.  Returns the launches of mixing_gossip_stacked and
    channel_gossip_stacked."""
    from repro_torch.core import (FlatGossipEngine, GossipMixer, World,
                                  params_from_graph, ring_graph)
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.launch import gossip_train as gt
    from repro_torch.models.resnet import resnet_loss
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    world = World(topology=graph, comms_per_grad=TRAIN_COMMS)
    stream = SyntheticCIFAR(batch_size=BATCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    batches = [stream.sample_workers(gen, N_WORKERS)
               for _ in range(TRAIN_STEPS)]

    def grad_fn(p, batch):
        g, (loss, m) = torch.func.grad_and_value(
            lambda q: resnet_loss(q, cfg, batch), has_aux=True)(p)
        return (loss, m), g

    timer = ReplayTimer()
    orig_grads = gt.StackedGossipTrainer._vmapped_grads
    saved = {k: FlatGossipEngine.__dict__[k] for k in
             ("batch", "channel_batch")}
    gt.StackedGossipTrainer._vmapped_grads = timer.wrap("grad", orig_grads)
    FlatGossipEngine.batch = timer.wrap("kernel", saved["batch"])
    FlatGossipEngine.channel_batch = timer.wrap("kernel",
                                                saved["channel_batch"])
    out = {"mixing_gossip_stacked": 0, "channel_gossip_stacked": 0}
    try:
        for arm, kw in trainer_arms(graph).items():
            trainer = gt.StackedGossipTrainer.from_world(
                world, grad_fn, sgd(), lr=TRAIN_LR, **kw)
            state = trainer.init(params0, torch.Generator().manual_seed(
                SEED + 18))
            step = trainer.make_step()
            if arm == "baseline":
                timer.arm = "warm-up"
                step(state, batches[0])
            timer.arm = arm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, walls, draws, losses = run_trainer_arm(
                f"stacked {arm}", trainer, state, step, batches)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            applied = sum(int((d.idxs >= 0).sum()) for d in draws)
            events = TRAIN_STEPS * trainer.comms_per_step
            name = "channel_gossip_stacked" if arm == "channel" \
                else "mixing_gossip_stacked"
            want = applied if arm == "channel" else events
            require(launches[name] == want and only_launched(launches, name),
                    f"stacked {arm}: launches {launches}, want {name} == "
                    f"{want} and nothing else")
            out[name] += launches[name]
            grad, kern = timer.ms(arm, "grad"), timer.ms(arm, "kernel")
            require(len(grad) == TRAIN_STEPS and len(kern) == want,
                    f"stacked {arm}: timed {len(grad)} gradients and "
                    f"{len(kern)} kernel calls")
            rest = (sum(walls) - sum(grad) - sum(kern)) / TRAIN_STEPS
            print(f"[{card}] stacked {arm}: loss {losses}, "
                  f"{events - applied} dropped events; {name} launches "
                  f"{launches[name]} == {want}, every other kernel 0; peak "
                  f"memory {peak / 2**30:.2f} GiB")
            print(f"[{card}] stacked {arm} step breakdown (CUDA events in "
                  f"the step): vmapped gradient ({N_WORKERS} workers x "
                  f"{BATCH}) {np.mean(grad):.2f} ms "
                  f"{[round(t, 2) for t in grad]}, event kernel"
                  f"{' with gather and norms' if arm == 'channel' else ''} "
                  f"{np.mean(kern):.4f} ms x {len(kern)}, rest (mix, update,"
                  f" pack, unpack, draws, host) {rest:.2f} ms a step; step "
                  f"{np.mean(walls):.1f} ms {[round(t, 1) for t in walls]}")
            del state
    finally:
        gt.StackedGossipTrainer._vmapped_grads = orig_grads
        for k, v in saved.items():
            setattr(FlatGossipEngine, k, v)

    # the SPMD event loop against the stacked one on shared gaps, per row
    acid = params_from_graph(graph, True)
    mixer = GossipMixer(graph, acid)
    idxs, gaps = mixer.sample_event_batch(torch.Generator().manual_seed(
        SEED + 19), 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    xs = [tree_map(lambda a: a + 0.01 * torch.randn(
        a.shape, generator=gen, device=dev), params0)
        for _ in range(N_WORKERS)]
    xts = [tree_map(lambda a: a + 0.01 * torch.randn(
        a.shape, generator=gen, device=dev), params0)
        for _ in range(N_WORKERS)]
    reset_launches()
    sx, sxt = mixer.gossip_events(xs, xts, idxs, gaps)
    engine = FlatGossipEngine.for_pytree(params0, acid, stacked=False)
    sbx = torch.stack([engine.pack_local(t) for t in sx])
    sbxt = torch.stack([engine.pack_local(t) for t in sxt])
    del sx, sxt
    bx = torch.stack([engine.pack_local(t) for t in xs])
    bxt = torch.stack([engine.pack_local(t) for t in xts])
    del xs, xts
    stacked = FlatGossipEngine(engine.layout, acid)
    shared = gaps.to(dev)[:, None].expand(-1, N_WORKERS).contiguous()
    bx, bxt = stacked.mix(bx, bxt, shared[0])
    nxt = torch.cat([shared[1:], shared.new_zeros((1, N_WORKERS))])
    bank = torch.as_tensor(mixer.bank, device=dev)
    for e, idx in enumerate(idxs.tolist()):
        bx, bxt = stacked.batch(bx, bxt, bank[idx], nxt[e])
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches["p2p_mixing"] == 4 * N_WORKERS
            and launches["mixing_gossip_stacked"] == 4,
            f"SPMD vs stacked loops launched {launches}")
    require(torch.equal(sbx, bx) and torch.equal(sbxt, bxt),
            "the SPMD and the stacked event loops differ")
    print(f"[{card}] SPMD vs stacked event loop, 4 events on shared gaps, "
          f"{N_WORKERS} x {engine.layout.d}: every row equal bit for bit "
          f"({launches['p2p_mixing']} p2p_mixing against "
          f"{launches['mixing_gossip_stacked']} mixing_gossip_stacked "
          f"launches)")
    del sbx, sbxt, bx, bxt

    # one pair-ring step and one AR step: finite, no gossip kernel
    trainer = gt.StackedGossipTrainer.from_world(world, grad_fn, sgd(),
                                                 lr=TRAIN_LR)
    for label, make in (("pair-ring", trainer.make_pair_ring_step),
                        ("AR", trainer.make_ar_step)):
        state = trainer.init(params0, torch.Generator().manual_seed(SEED))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = make()(state, batches[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        require(np.isfinite(float(metrics["loss"]))
                and all(v == 0 for v in launches.values()),
                f"{label} step: loss {float(metrics['loss'])}, launches "
                f"{launches}")
        require(all(bool(torch.isfinite(a).all())
                    for a in tree_leaves(state.x)),
                f"{label}: non-finite state")
        print(f"[{card}] stacked {label} step: loss "
              f"{float(metrics['loss']):.4f}, finite, no gossip kernel "
              f"launched; {wall:.1f} ms (host clock)")
        del state
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.flatbuf import FlatLayout
    from repro_torch.core.a2cid2 import params_from_graph
    from repro_torch.core.graphs import ring_graph
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.kernels.build import build_all
    from repro_torch.models.resnet import (init_resnet, resnet18_cifar,
                                           resnet_grad_fn)

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[{card}] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t_start = t0 = time.perf_counter()
    built = build_all()
    print(f"[{card}] built {', '.join(p.name for p, _ in built.values())} "
          f"in {time.perf_counter() - t0:.1f} s (one nvcc each, in "
          f"parallel)")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{card}] ptxas {name}: {line.strip()}")

    cfg = resnet18_cifar()
    params0 = init_resnet(torch.Generator(device="cuda").manual_seed(SEED),
                          cfg)
    layout = FlatLayout.from_pytree(params0)
    print(f"[{card}] resnet18_cifar: {layout.d_real} parameters in "
          f"{len(layout.specs)} leaves, D = {layout.d}")
    dyn_p = params_from_graph(ring_graph(N_WORKERS), True)
    dyn = dict(eta=dyn_p.eta, alpha=dyn_p.alpha, alpha_t=dyn_p.alpha_tilde)
    rows = {"mixing_gossip_stacked": phase_kernel(card, layout.d,
                                                  layout.d_real, dyn)}
    torch.cuda.empty_cache()
    launches = {"mixing_gossip_stacked": phase_slice(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)}
    phase_engine_vs_reference(card)
    torch.cuda.empty_cache()
    rows["channel_gossip_stacked"] = phase_channel_kernel(
        card, layout.d, layout.d_real, dyn)
    torch.cuda.empty_cache()
    launches["channel_gossip_stacked"] = phase_channel_slice(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    phase_channel_engine_vs_reference(card)
    torch.cuda.empty_cache()
    rows.update(phase_worlds_kernels(card, layout.d, layout.d_real, dyn))
    torch.cuda.empty_cache()
    launches["mixing_gossip_worlds"] = phase_worlds_slice(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    torch.cuda.empty_cache()
    launches["channel_gossip_worlds"] = phase_channel_worlds_slice(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    phase_worlds_vs_serial(card)
    torch.cuda.empty_cache()
    flash_rows = phase_flash_kernel(card)
    rows["flash_attention_bhsd"] = flash_rows["nano-lm prefill"]
    rows["rmsnorm_2d"] = phase_rmsnorm_kernel(card)
    launches["rmsnorm_2d"] = 0     # no model calls it
    torch.cuda.empty_cache()
    lm_launches, nano, stream, consensus = phase_lm_replay(card)
    launches["mixing_gossip_stacked"] += lm_launches   # phases 3 and 13
    torch.cuda.empty_cache()
    phase_lm_engine_vs_reference(card, nano, stream)
    torch.cuda.empty_cache()
    launches["flash_attention_bhsd"] = phase_prefill(card, nano, consensus,
                                                     stream)
    del consensus, stream
    print(f"[{card}] phases 1-14 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    rows["p2p_mixing"] = phase_p2p_kernel(card, layout.d, layout.d_real, dyn)
    rows["channel_gossip_stacked"]["max_abs_err"] = max(
        rows["channel_gossip_stacked"]["max_abs_err"],
        phase_channel_local(card, layout.d, layout.d_real, dyn))
    torch.cuda.empty_cache()
    rows["mixing_p2p"], launches["mixing_p2p"] = phase_mixing_p2p(
        card, params0, dyn)
    torch.cuda.empty_cache()
    spmd = phase_spmd_slice(card, params0, cfg)
    launches["p2p_mixing"] = spmd["p2p_mixing"]
    torch.cuda.empty_cache()
    stacked = phase_stacked_slice(card, params0, cfg)
    launches["mixing_gossip_stacked"] += stacked["mixing_gossip_stacked"]
    launches["channel_gossip_stacked"] += (spmd["channel_gossip_stacked"]
                                           + stacked["channel_gossip_stacked"])
    print(f"[{card}] phases 1-18 done at {time.perf_counter() - t_start:.1f}"
          f" s")

    print(card)
    print(json.dumps({"kernels": [
        {**KERNELS[name], "launches": launches[name], **rows[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
