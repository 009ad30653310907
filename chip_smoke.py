"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

It needs one card, the CUDA toolkit (``nvcc``) and this checkout; it never
imports JAX or the JAX package.  Phases, each fatal on failure:

  1. device and build: the card, the TF32 settings (both set off: f32
     means f32 here), all eleven hand kernels built from ``src/`` in parallel
     (``kernels/build.py``) with nvcc's register and spill report;
  2. the clean kernel ``mixing_gossip_stacked`` bit for bit its plain
     PyTorch version on the same inputs, at the slice's real shape (16
     workers x ResNet-18-CIFAR's padded width, f32), at a small bf16 shape
     and on eight small partner maps at D = 128 and 4224, f32 and bf16 (W
     = 1, 2, 15; no idle row, all idle; the pair (0, W - 1); a map that is
     not an involution), with the exact identities (an idle row with eta =
     0 is untouched, padding columns stay 0), and its time beside the
     earlier design's, its memory bound and the plain version's time;
  3. the clean slice: ResNet-18-CIFAR at full width, 16 workers on a ring,
     a SyntheticCIFAR batch of 32 per worker, the baseline and the A2CiD2
     arm for 4 rounds each at one comm per gradient, through
     ``Simulator.run_schedule``, with every comm batch and gradient tick
     timed by CUDA events; the clean kernel's launch count must equal the
     stream's comm steps, the one-pass tick tail ``tick_tail_stacked`` must
     launch once a gradient tick (and the channel kernel must not launch),
     losses
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
     64) and (32, 4096, 128) bf16, RecurrentGemma-9B's local attention
     (16, 2048, 256) with a window of 2048, and the padded head dims of
     DeepSeek-V3's MTP block (256, 511, 56) and (96, 1024, 32), causal,
     each at f32 and bf16, on live rows (atol 2e-5, rtol 1e-4 at
     f32, the JAX package's tolerance; atol 3e-2 at bf16, the JAX
     package's, and each element within 2^-7 |ref| + 2^-8 sum_c p_c |v_c|,
     which the kernel with the last 64 keys of head 0 dropped must break);
     the kernel's 0 on rows with no live column pinned exactly; the count of tensor-core instructions in the built library
     (HGMMA for wgmma, HMMA for mma.sync, by ``cuobjdump -sass``); each
     shape's time (mean of 20 launches) beside the bound of its route
     (bf16 on wgmma at 989 TFLOP/s; f32 as 3xTF32, three TF32 products a
     product at 494.7 TFLOP/s; each against bytes at 3.35 TB/s) and the
     CUDA-core f32 bound of earlier records, the plain version's time and
     ``scaled_dot_product_attention``'s;
 12. the RMSNorm kernel ``rmsnorm_2d`` against its plain version at
     (8192, 768), (8192, 1024), (64, 8192) and (16, 16384) f32 and bf16,
     (130, 768), (1, 256), (1, 7), (3, 1000), (3, 250), (4, 1001) and
     (2, 8193), and on views that start off a 16-byte boundary (atol 1e-5
     at f32, 2e-2 at bf16; out aligned as x), with the four large shapes
     timed eagerly and in a CUDA graph beside its bound, the plain
     version's time and ``torch.nn.functional.rms_norm``'s, timed the same
     two ways, and ``x.clone()`` (the same bytes) in a graph.  No model
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
     then Qwen3-0.6B again with bf16 weights and compute (the same seed),
     its 28 flash launches on bf16 and no other kernel, the logits within
     max|d| / max|logit| < 3e-2 of the bf16 xla path and of the same
     forward through the plain flash version, where a 64-key tile dropped
     from every head in every layer must read above 3e-2;
 15. the per-worker event kernel ``p2p_mixing`` against its plain version at
     ResNet-18-CIFAR's padded width (11,171,328) f32 and bf16, bit for
     bit, with x~ written in place beside a fresh out_x, the exact
     identities (xp = x with eta = 0 a no-op, alpha = alpha~ = 0 the mixing
     step, padding 0), each row bit for bit what ``mixing_gossip_stacked``
     computes for it; its time beside its 0.0667 ms bound;
 16. ``mixing_p2p`` through ``ops.gossip_event_pytree`` on the 56 leaves of
     the ResNet-18-CIFAR tree, f32 and bf16, bit for bit its plain version
     in ONE launch a tree (the leaves in a table passed by value), and
     nothing else launched; bit for bit also on odd lengths and views at
     odd element offsets (as one tree and alone) and on a tree of 129
     leaves of both dtypes, wider than a launch takes (3 launches); a CUDA
     graph of the tree bit for bit the eager tree; the tree's times, eager
     and in a graph, f32 and bf16, beside the summed bound, the earlier
     per-leaf kernel's (``EARLIER_TREE_*``), the plain version and a
     ``torch._foreach_*`` composition of the same arithmetic; the host
     time of one call split into checks, outputs, table, launch and rest;
     the kernel alone on the largest leaf beside its bound;
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
     kernel;
 19. telemetry on the card (cuDNN set deterministic from here on, so that
     two replays can be held bit for bit): (a) phase 5's hostile channel
     slice, static trim and defense arms, replayed with ``Telemetry()``
     from the same start as without: x, x~, loss, consensus and the
     defense trace bit for bit, the launches equal, per round applied +
     rejected + dropped == scheduled exactly, the defense arm rejecting,
     row_bytes 44,685,096, the host-clock overhead a round; (b) phase 3's
     clean A2CiD2 arm with ``Telemetry()``: ``channel_gossip_stacked`` once
     a comm step, ``mixing_gossip_stacked`` never, x, x~ and losses bit
     for bit the clean replay (the channel kernel at corrupt 0 / mscale 1
     / no clip is the clean one; the eager tail is ``tick_tail_stacked``'s
     arithmetic), the rows within 1e-6 (the clean replay's row comes from
     the tick kernel's sums); (c) engine columns against the per-event
     replay's on the
     quadratic (counts exactly, moments within 1e-5 relative); (d) phase
     9's channel + defense worlds with ``Telemetry()`` in one
     ``run_worlds`` call, bit for bit the batch without it, and on the
     quadratic each world's columns against its serial replay's;
 20. ``run_world(state, World(ring, telemetry=Telemetry()), 4, seed=0)``
     bit for bit ``run_schedule`` of ``world.compile(4, seed=0)``, and
     ``allreduce_sgd`` (AR-SGD) for 4 rounds on ResNet-18-CIFAR, 16
     workers: finite losses, no gossip kernel, the 16 rows bit for bit
     equal after every round, each round timed by CUDA events;
 21. ``launch.train.run_sync`` on nano-lm at full width (128,404,224
     parameters) at the CLI's defaults (batch 8 x 128, lr 0.05, ``sgd()``),
     4 steps, then the same 4 batches with ``remat=True`` and with 2
     micro-batches of 4, losses and parameters within 1e-4 of the plain
     run's (relative to each tensor's largest magnitude); per step the
     forward + backward and the optimizer by CUDA events and the peak
     device memory; then ``--ckpt``: the params and a whole ``TrainState``
     restored bit for bit into fresh trees, a bf16 copy round-tripped bit
     for bit, retention keeping the last 3 of 5 saves, and ``run_sim
     --ckpt`` (2 workers, 2 rounds) writing the stacked x, reloaded bit
     for bit;
 22. decode: ``launch.serve.generate`` on Qwen3-0.6B at full width (f32,
     weights from seed 0) at the serve CLI's defaults (batch 4, prompt 32,
     gen 32, greedy): the decode logits of the 32 prompt positions within
     2e-4 of the largest logit of ``Model.forward`` (xla), ``generate``'s
     ids the token-by-token loop's, a (B,) position vector bit for bit the
     duplicated-row references at the same batch shape; prefill and each
     decode step timed by CUDA events beside the weight-read bound
     (2.385 GB / 3.35 TB/s), tokens/s and the peak memory;
 23. ``ContinuousBatcher`` on the same model, 4 slots of 128 rows, 8
     requests of 8-40 prompt and 8-32 new tokens admitted as slots free
     up: each finishes with exactly max_new ids, equal to its own
     ``generate``'s; steps, slot occupancy and a step's time;
 24. ``GossipFleet`` on nano-lm at full width, 4 replicas on a ring (the
     (4, D) f32 bank 2.05 GB), A2CiD2 over a channel of delay horizon 2 /
     prob 0.3 and drop 0.1, the JAX serve bench's load, drift "perturb" at
     0.02, a stall of 0.03 an event, 12 rounds and the drain: the lossy
     arm's bank and consensus prefix bit for bit ``run_schedule(engine=
     False)``'s and nothing lost; a churn arm (a replica killed at round 4)
     losing nothing and restarting at least one request; a drift-off arm
     with a stall of 1.0 an event whose bank stays bit for bit and whose
     every request's ids are ``generate``'s; per round the gossip
     (``_round_channel``, the host waiting for its end) and decode times
     by CUDA events and the host rest, tokens/s.  Phases 22-24 launch no
     hand kernel (the JAX serving path reaches none), and each requires the
     counts to stay 0;
 25. DeepSeek-V3 at published widths (d_model 7168, 128 heads, q / kv
     ranks 1536 / 512, 256 experts of 2048 at top-8 with a shared expert,
     vocab 129,280, MTP), its 61 layers cut to 2 (MLA + dense, MLA + MoE),
     bf16 (14,648,806,400 parameters): ``loss`` on 2 x 512 tokens (ce, aux,
     mtp finite, aux > 0), the share of token-expert picks dropped at
     capacity 1.25 and the forward's time split into MoE dispatch and
     combine, expert products and the rest (CUDA events); ``generate``
     (batch 4, prompt 32, gen 32) equal to the token loop's ids, no pick
     dropped in decode, the MLA cache's 576 values a token a layer beside
     expanded K / V's 40,960, the decode step beside its weight-read bound;
     no hand kernel;
 26. mamba2-780m (780,382,464 parameters) and recurrentgemma-9b
     (9,396,408,320) at full size, f32: decode against ``forward`` within
     2e-4 (B = 2, S = 256 and 64), Mamba-2's ``generate`` equal to the token
     loop's and its cache one size at lengths 32 and 4096, a 2 x 2048
     Mamba-2 forward timed; RecurrentGemma's forward with
     ``attention_impl="pallas"`` on 1 x 2048 tokens within 2e-4 of the xla
     path's, flash launched once per local-attention layer (12) at (16,
     2048, 256), nothing else launched; each decode step beside its
     weight-read bound;
 27. the four families reduced, f32: decode against forward within 2e-4
     (MoE capacity 8), RecurrentGemma's ``windowed(8)`` ring caches, 8
     ``make_train_step`` steps of ``sgd(momentum=0.0)`` at lr 0.05 lowering
     the loss, ``lm_grad_fn``'s vmapped gradients for 2 workers within 1e-6
     of the largest gradient from separate ``grad_and_value`` calls in f64
     (1e-4 in f32: cuBLAS's batched GEMMs sum in another order), and a
     2-round ``run_sim`` on reduced DeepSeek-V3 (finite losses,
     ``mixing_gossip_stacked`` once a comm step, nothing else launched);
 28. the sharded replay (``run_worlds(mesh=MeshReplay(...))``): first
     ``channel_gossip_worlds`` against its plain version at every shard
     shape the phase launches it at ((4, 4, D), (1, 4, D), (1, 8, D) f32;
     (4, Ws, 4224 / 1024) f32 and bf16, Ws 1 to 16); (a) phase
     9's worlds on a noisy row-local quadratic at D = 11,171,328 (B = 4 x
     16 workers, ``Telemetry()``) on one device and on 4 local shards of
     the card: x, x~, clocks, generators, the defense trace and the
     telemetry counts bit for bit, the traces within 1e-6; the comm step
     split by CUDA events (gather, publish, exchange, merge, norms,
     kernel, rest), the median of 3 runs an arm in alternating order
     after a warm-up, and the peak memory of each; the replay's delta
     norms (blocks of 8 rows) beside each row alone and one sum, row
     count independence and times at (4, 16), (4, 4) and (1, 64) rows;
     lags 1 and 2 on a clean ring bit for bit the
     single-device replay of ``shard_lag_schedule``; (b)
     ``channel_gossip_worlds`` launches == comm steps x 4 and nothing
     else; (c) NS = 1, 2, 4, 8, 16 at D = 4224 and 1001 (padded), f32 and
     bf16, channel and defense flavours, bit for bit, and the ragged
     fallback (n = 15 on 2 shards warns and replays on one device); (d) 64
     workers on a ring, 8 shards, full width, bit for bit; (e)
     ResNet-18-CIFAR through ``resnet_grad_fn``'s draw / apply split on 4
     shards, bit for bit the single-device replay whose gradient is
     applied in the shards' row groups, and within 1e-4 of max|x| of the
     default single-device replay (a sound control, gradients in 8-row
     groups, must stay under that and a fault control, lag 2, must break
     it); one tick's gradients timed and compared under ``vmap`` and
     ``vmap(chunk_size=1)``, in one call and in the shards' groups; (f) ``make_rank_mesh()`` under NCCL at
     world size 1, bit for bit.
 29. the dry run (``launch.dryrun``) on the meta device, no card: (a)
     every architecture at decode_32k and long_500k and Qwen3-0.6B and
     DeepSeek-V3 at prefill_32k on the single-pod mesh, and the six
     gossip modes, each passing (the full-size train steps and the other
     prefills run through the CLI, PERF.md); (b) on a one-card mesh
     Qwen3-0.6B's prefill at 2 x 4096 with flash, its decode at
     decode_32k cut to batch 4 and a nano-lm train step (16 x 512, 4
     micro-batches), bf16, built by ``bundle_for``, traced on the meta
     device, then run on the card: the card's argument bytes exactly the
     dry run's, the FLOPs counted on the card (flash reporting through
     ``op_cost.record``, 28 launches) exactly the meta trace's, the peak
     allocation above the arguments over the meta trace's peak inside
     ``MEMORY_RATIO``, and the step's time (median of 5, CUDA events)
     beside its roofline bound; (c) ``worlds_executable`` on phase 9's
     worlds (2 rounds): ``fn(*args)`` bit for bit ``run_worlds``.
 30. (a) ``models.layers.rmsnorm``'s custom VJP (JAX's
     ``_rmsnorm_fwd`` / ``_rmsnorm_bwd`` as an ``autograd.Function``) at
     (8192, 1024) and (4, 4096, 1024), f32 and bf16: out, gx and gscale
     on the card against the same function on CPU copies, within 1e-5
     (f32) and 2e-2 (bf16, the JAX package's RMSNorm tolerance) of each
     output's largest magnitude, with the bitwise share; forward +
     backward at (8192, 1024) timed beside the earlier autograd form's
     recorded times; ``vmap`` of ``grad`` over 8 workers against single
     calls.  (b) the four example twins
     (``repro_torch.examples``) at their defaults, in this process, each
     path with the launch counts set to 0 just before it and read just
     after: each quickstart section (``mixing_gossip_stacked`` once a comm
     step of the calm and hostile arms' streams, ``channel_gossip_stacked``
     of the lossy and self-healing arms', ``mixing_gossip_worlds`` once a
     shared step of the sweep, nothing else), with A2CiD2's consensus
     below the baseline's on the calm ring, the adaptive defense
     rejecting, and the static trim rejecting 0 (a ``Telemetry()`` replay
     of its world, bit for bit the section's arm); ``cifar_decentralized``
     (ResNet-8, 25 rounds) and ``lm_decentralized`` (reduced nano-lm, 200
     rounds; then ``--full --rounds 4``, nano-lm at full width, with a
     stream that skips the header's entropy rate): the clean kernel once
     a comm step of each arm and the tick tail once a gradient tick (as
     in the calm and hostile sections), losses finite; ``serve_lm`` (8 replicas, 60
     rounds, a kill at round 20): no hand kernel, nothing lost, a
     restart; every printed line the twin's own.  Each quickstart
     section and both CIFAR arms are replayed again on the per-event
     path (no hand kernel) and held against the kernels' replay: x and
     x~ finite-or-not exactly, each worker's row within 1e-5 of its
     largest magnitude, the loss and consensus traces at rtol 1e-5; and
     each kernel against its plain version at every shape and dynamics
     a twin launched it at (the clean kernel bit for bit, the channel
     and worlds kernels within 1e-5; the tick tail inside the clean
     paths, at the first tick of each leaf geometry and dynamics, on the
     replay's own gradients: x and x~ bit for bit, the row within 1e-6),
     its error into the kernel's JSON row.  Then ``python -m repro_torch.examples.quickstart`` in its own
     process, on the card by default.
 31. the tick tail ``tick_tail_stacked`` (the descent of x and x~, the
     metrics row and the trailing mix in one pass, reading the gradient
     leaves where they lie) at ResNet-18-CIFAR's (16, 11,171,328) with the
     real gradient leaves of a 32-image batch (the convolutions' strided
     views through the runs path) and at the LM cell's (4, 313,024,000)
     (Qwen3-0.6B at 10 layers, f32, random contiguous leaves): x and x~
     bit for bit the plain version, the row within 1e-6, each time beside
     its bytes bound (each leaf read once, x and x~ read and written once,
     at 3.35 TB/s) and beside the eager PyTorch sequence it replaces
     (``Simulator._grad_tick``'s descent and row, then ``engine.mix``).
 32. the dropless experts ``moe_experts`` at the Kanana-2 cell's shape (4
     workers of one 1,024-token sequence, top-6 of 128 experts, 8 held,
     d 2048, expert width 768, random picks): the routing tables, the
     grouped products, the combine and the backward, one launch of each
     of the ten ops, the output and the five gradients within 1e-5 of
     the dense plain version's largest values; forward and backward
     timed beside their bound (the held rows' FLOPs on the CUDA cores,
     or the launches' least bytes) and the plain version's.
 33. the f32 weight products ``gemm_3xtf32`` (3xTF32 on wgmma): the HGMMA
     count of the built library's SASS (none fails); at each product
     shape of the two LM cells (forward, dX and dW of Qwen3-0.6B's and
     Kanana-2's projections, MLPs and heads, W = 4 workers of 1,024
     tokens, operands in the layouts the tick hands over) within 1e-6 of
     the largest element of |A| |B| from ``torch.matmul``
     (``max_rel_err``; cuBLAS's plain TF32 reads 9.6e-6 at the tied
     head's dX, the kernel 3.3e-7), timed beside its bound (3xTF32 at
     164.9 TFLOP/s or the bytes; a time below it fails) and beside
     ``torch.matmul`` (TF32 off: FFMA on the CUDA cores, the yardstick
     ``library_ms``); then one ``lm_grad_fn`` tick of reduced Qwen3 and
     Kanana-2 blocks at 4 workers of 256 tokens with a tracer active,
     whose ``dense`` counter must carry every weight product on the
     kernel, as many launches as products, 3 a weight product.  Every
     f32 LM phase before launches the kernel beside its own: each holds
     its launches to the count its config gives (``weight_products``:
     one a weight product of a forward whose rows reach 64, three in a
     gradient), and a bf16 model, a decode step or a ResNet none.

The line before the last is a JSON summary of every kernel, the last line
the status object.  Every printed number is prefixed with the card's name
and power limit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit),
# stated once in the port: memory, f32 on the CUDA cores, bf16 and TF32 on
# the tensor cores
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S, PEAK_FLOPS_BF16 as PEAK_BF16_FLOPS,
    PEAK_FLOPS_F32 as PEAK_F32_FLOPS, PEAK_FLOPS_TF32 as PEAK_TF32_FLOPS)

N_WORKERS, BATCH, ROUNDS, SEED, GAMMA = 16, 32, 4, 0, 0.01
# the channel slice: 6 rounds so that stale reads reach 2 snapshots back;
# schedule seed 1 puts 8 corrupted reads in them, the first in round 0
CHANNEL_ROUNDS, CHANNEL_SEED = 6, 1
# the repo's own channel settings (benchmarks/run.py, _CHAN_BENCH): scale
# 1e3 at a 50% duty cycle, stale prob 1, trim at tau 5
ROBUST_CLIP = 5.0
F32_TOL = 1e-5      # kernel vs plain, f32: same correctly rounded ops, exp
# mixing_gossip_stacked vs plain at both dtypes: the same operations in the
# same order (expf on both sides), so bit for bit
EXACT = 0.0
# the earlier gossip kernels' times, as PERF.md section 6 records them
# (NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
EARLIER_STACKED_MS, EARLIER_WORLDS_MS = 1.1627, 4.6092
EARLIER_LM_COMM_MS = 7.13
# the earlier mixing_p2p, one launch a leaf: the f32 ResNet-18 tree eagerly and
# as one CUDA graph (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W)
EARLIER_TREE_EAGER_MS, EARLIER_TREE_GRAPH_MS = 3.9799, 0.1954
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
# flash kernel vs plain: the JAX package's kernel-vs-oracle tolerances
FLASH_F32_TOL = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16_ATOL = 3e-2
# and, at bf16, |out - ref| <= 2^-7 |ref| + 2^-8 sum_c p_c |v_c| on every
# live element: the first-order bound of the three roundings between the
# kernel and its plain version (bf16's unit roundoff 2^-8 each): P before
# P V, the kernel's output and the plain version's output
FLASH_BF16_REL, FLASH_BF16_P = 2.0 ** -7, 2.0 ** -8
RMSNORM_F32_ATOL = 1e-5    # the JAX package's rmsnorm kernel test
RMSNORM_BF16_ATOL = 2e-2
MODEL_TOL = 2e-4           # pallas vs xla logits, max|d| / max|logit|
# the same at bf16 weights and compute, against the xla path and against
# the same forward through the plain flash version: 28 bf16 layers carry
# any rounding difference in attention to ~1.8e-2 of the largest logit,
# where a 64-key tile dropped from every head reads ~0.14 (PERF.md
# section 2)
MODEL_BF16_TOL = 3e-2
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
        "instructions": "bf16: wgmma (HGMMA); f32 3xTF32: Q.K^T on TF32 "
                        "wgmma (HGMMA), P.V on mma.sync (HMMA)",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bhsd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:81"},
    "rmsnorm_2d": {
        "name": "rmsnorm_2d", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_2d.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:27"},
    "tick_tail_stacked": {
        "name": "tick_tail_stacked", "route": "cuda",
        "source": "src/repro_torch/kernels/a2cid2_mixing/csrc/"
                  "tick_tail_stacked.cu",
        "replaces": "none: the JAX package leaves the tick's tail to XLA"},
    "moe_experts": {
        "name": "moe_experts", "route": "cuda",
        "instructions": "f32 FFMA on the CUDA cores",
        "source": "src/repro_torch/kernels/moe_experts/csrc/moe_experts.cu",
        "replaces": "none: the JAX package dispatches MoE picks into "
                    "capacity buffers (models/layers.py)"},
    "gemm_3xtf32": {
        "name": "gemm_3xtf32", "route": "cuda",
        "instructions": "f32 as 3xTF32 on wgmma (HGMMA)",
        "source": "src/repro_torch/kernels/dense_f32/csrc/gemm_3xtf32.cu",
        "replaces": "none: the JAX package leaves the weight products to "
                    "XLA"},
}
# the f32 weight products of every model on the card (``models`` call
# ``kernels/dense_f32``'s ``dense``): each f32 LM phase holds its launches
# to ``weight_products`` (``require_products``), which tallies them here
DENSE = "gemm_3xtf32"
DENSE_TALLY = {"launches": 0}
# the clean replay on the card: the clean kernel once a comm step, the
# one-pass tick tail once a gradient tick
CLEAN_REPLAY = ("mixing_gossip_stacked", "tick_tail_stacked")


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


def only_launched(launches: dict, *names: str) -> bool:
    """True when no kernel other than ``names`` launched."""
    return all(v == 0 for k, v in launches.items() if k not in names)


def weight_products(cfg, batch: int, seq: int, loss: bool = False,
                    cache: int = 0) -> int:
    """The ``gemm_3xtf32`` launches of one forward of ``cfg`` on (batch,
    seq) tokens, from the config alone: each weight product of a block (q,
    k, v and o of GQA; MLA's q, or its q down and up, then kv down, k up,
    v up and o; an MLP's up and down, and gate where it is gated: of a
    dense layer, of a MoE's shared expert and of its parallel dense MLP)
    and the head, where the model is f32 and the product's rows reach
    ``dense_f32.ops.MIN_ROWS``; with ``loss``, the multi-token prediction
    block's and its head's on seq - 1 rows too.  With ``cache``, one
    decode step (seq 1) against caches of that length: no o (``matmul``),
    and MLA's k and v up-projections on the cache's batch x cache rows.
    A gradient launches three a product (Y, dX, dW)."""
    from repro_torch.kernels.dense_f32.ops import MIN_ROWS
    from repro_torch.models.transformer import mtp_block
    if not cfg.param_dtype == cfg.compute_dtype == "float32":
        return 0
    mlp = 3 if cfg.mlp_act == "silu" else 2

    def block(b, rows: int) -> int:
        on = rows >= MIN_ROWS
        n = 0
        if b.mixer == "attn":
            n = on * (3 if cache else 4)
        elif b.mixer == "mla":
            q = 1 if cfg.mla.q_lora_rank is None else 2
            n = on * (q + 1 + (not cache))
            n += 2 * ((batch * cache if cache else rows) >= MIN_ROWS)
        if b.mlp == "dense":
            n += on * mlp
        elif b.mlp != "none":
            n += on * mlp * (bool(cfg.moe.shared_expert)
                             + bool(cfg.moe.dense_d_ff))
        return n

    rows = batch * (1 if cache else seq)
    n = sum(block(b, rows) for b in cfg.all_blocks()) + (rows >= MIN_ROWS)
    if loss and cfg.mtp and cfg.input_mode == "tokens":
        rows = batch * (seq - 1)
        n += block(mtp_block(cfg), rows) + (rows >= MIN_ROWS)
    return n


def require_products(launches: dict, want: int, what: str) -> int:
    """``gemm_3xtf32`` launched exactly ``want`` times in the window (its
    count from ``weight_products``); the launches join the tally."""
    got = launches[DENSE]
    require(got == want, f"{what}: gemm_3xtf32 launched {got} times, the "
                         f"weight products give {want}")
    DENSE_TALLY["launches"] += got
    return got


class ReplayTimer:
    """CUDA-event pairs around calls made inside a replay, keyed by
    (arm, kind); nothing waits for the card until ``ms`` is read."""

    def __init__(self):
        self.events: dict[tuple[str, str], list] = {}
        self.arm = "warm-up"

    def wrap(self, kind, fn, sync: bool = False):
        """``fn`` with a CUDA-event pair around each call; with ``sync``
        the host waits for the call's end event (so a host-clock span
        around it holds its device work)."""
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            if sync:
                end.synchronize()
            self.events.setdefault((self.arm, kind), []).append((start, end))
            return out
        return call

    def ms(self, arm, kind) -> list[float]:
        return [s.elapsed_time(e) for s, e in self.events.get((arm, kind),
                                                              [])]


# ---------------------------------------------------------- clean kernel
def check_kernel(card, kernel, ref, dyn, w, d, d_real, dtype, tol, gen,
                 idle: int = 4):
    """Kernel vs plain version on one input set (``idle`` rows left out of
    the matching), plus the exact identities.  Returns (max_abs_err,
    inputs)."""
    dev = torch.device("cuda")
    partner_np = involution(w, idle=idle, seed=d)
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


def partner_maps() -> list:
    """(label, partner) maps of phase 1's small checks: the sizes and
    shapes of matching that the kernel's pair path must get right, and one
    map outside the contract (row 2 points at a paired row, rows 4-6 a
    3-cycle) that takes its row-by-row path."""
    def ends(w):
        p = np.arange(w, dtype=np.int32)
        p[0], p[-1] = w - 1, 0
        return p
    return [("W=1", np.zeros(1, np.int32)),
            ("W=2, one pair", np.array([1, 0], np.int32)),
            ("W=15, 1 idle", involution(15, idle=1, seed=15)),
            ("W=16, 0 idle", involution(16, idle=0, seed=16)),
            ("W=16, all idle", np.arange(16, dtype=np.int32)),
            ("W=16, the pair (0, 15)", ends(16)),
            ("W=15, the pair (0, 14)", ends(15)),
            ("W=8, not an involution",
             np.array([1, 0, 0, 3, 5, 6, 4, 7], np.int32))]


def check_partner_maps(card, kernel, plain, dyn, gen) -> None:
    """The kernel bit for bit its plain version on every map of
    ``partner_maps`` at D = 128 (one vector a thread at most) and 4224 (33
    vectors of 128 f32 values, so a pair's halves are uneven), f32 and
    bf16."""
    dev = torch.device("cuda")
    n = 0
    for label, partner_np in partner_maps():
        w = len(partner_np)
        partner = torch.from_numpy(partner_np).to(dev)
        for d in (128, 4224):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(w, d, generator=gen, device=dev).to(dtype)
                xt = torch.randn(w, d, generator=gen, device=dev).to(dtype)
                dt = torch.rand(w, generator=gen, device=dev) * 1.5
                rx, rxt = plain(x, xt, partner, dt, **dyn)
                xt_in = xt.clone()
                kx, kxt = kernel(x, xt_in, partner, dt, **dyn)
                torch.cuda.synchronize()
                require(kxt.data_ptr() == xt_in.data_ptr(),
                        "x~ was not updated in place")
                require(torch.equal(kx, rx) and torch.equal(kxt, rxt),
                        f"kernel differs from plain on {label}, D = {d}, "
                        f"{dtype}")
                n += 1
    print(f"[{card}] kernel bit for bit the plain version on "
          f"{len(partner_maps())} partner maps x D in (128, 4224) x "
          f"(f32, bf16) = {n} cases: W = 1, 2, 15; 0 and all idle; the "
          f"pair (0, W-1); a map that is not an involution")


def phase_kernel(card, d, d_real, dyn):
    from repro_torch.kernels.a2cid2_mixing.kernel import mixing_gossip_stacked
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_stacked

    def plain(*args, **kw):  # the plain PyTorch version, on the card
        return gossip_event_stacked(*args, backend="ref", **kw)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_kernel(card, mixing_gossip_stacked, plain, dyn, N_WORKERS, 4096,
                 4096 - 54, torch.bfloat16, EXACT, gen)
    check_partner_maps(card, mixing_gossip_stacked, plain, dyn, gen)
    err, (x, xt, partner, dt) = check_kernel(
        card, mixing_gossip_stacked, plain, dyn,
        N_WORKERS, d, d_real, torch.float32, EXACT, gen)
    w = N_WORKERS
    xt_run = xt.clone()
    ms = cuda_ms(lambda: mixing_gossip_stacked(x, xt_run, partner, dt,
                                               **dyn), reps=20)
    plain_ms = cuda_ms(lambda: plain(x, xt, partner, dt, **dyn), reps=5,
                       warmup=1)
    # each input read once (x, x~, partner, dt), each output written once
    nbytes = 4 * w * d * x.element_size() + 2 * w * 4
    b = bound(nbytes, FLOPS_PER_ELEM * w * d)
    print(f"[{card}] kernel ({w}, {d}) f32: {ms:.4f} ms over 20 launches "
          f"(earlier design {EARLIER_STACKED_MS:.4f} ms), bound "
          f"{b['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; ops bound "
          f"{b['ops_ms']:.4f} ms), {b['bound_ms'] / ms:.1%} of the bound, "
          f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved, plain version "
          f"{plain_ms:.4f} ms; no single PyTorch call computes this "
          f"function (library_ms null)")
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
    require(launches["tick_tail_stacked"] == 2 * ROUNDS,
            f"the tick tail launched {launches['tick_tail_stacked']} times "
            f"for 2 x {ROUNDS} gradient ticks")
    require(only_launched(launches, *CLEAN_REPLAY),
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
          f"tick tail {launches['tick_tail_stacked']} == 2 x {ROUNDS}, "
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
              f"rest per tick (pack, tick tail, host) "
              f"{rest:.2f} ms; replay {wall:.1f} ms")
    return {name: launches[name]
            for name in ("mixing_gossip_stacked", "tick_tail_stacked")}


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


def hostile_worlds(graph):
    """Phase 9's batch: the hostile channel, {static trim, the self-healing
    defense} x {adpsgd, a2cid2}.  Returns (worlds, defenses, scheds)."""
    from repro_torch.core import AdaptiveDefense, Algorithm, World
    base = World(topology=graph, channel=hostile_channel(graph))
    worlds = [dataclasses.replace(base, algorithm=Algorithm(kind))
              for _ in range(2) for kind in ("adpsgd", "a2cid2")]
    defenses = [None, None, AdaptiveDefense(), AdaptiveDefense()]
    return worlds, defenses, [w.compile(CHANNEL_ROUNDS, seed=CHANNEL_SEED)
                              for w in worlds]


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
        earlier = (f" (earlier: {EARLIER_WORLDS_MS:.4f} ms)"
                   if name == "mixing_gossip_worlds" else "")
        print(f"[{card}] {name} ({N_WORLDS}, {N_WORKERS}, {d}) f32: "
              f"{ms:.4f} ms over 20 launches{earlier}, bound "
              f"{b['bound_ms']:.4f} ms "
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
    from repro_torch.core import (FlatGossipEngine, Simulator,
                                  params_from_graph, ring_graph)
    from repro_torch.core import engine as engine_mod
    graph = ring_graph(N_WORKERS)
    # arms: {static trim, self-healing defense} x {adpsgd, a2cid2}
    worlds, defenses, scheds = hostile_worlds(graph)
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
    mask of a window (a causal window no shorter than S masks nothing
    more: causal)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import attention_mask
    mask = None
    if causal and window is not None and window >= q.shape[1]:
        window = None
    if window is not None:
        mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                              window=window, device=q.device)
    return F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask,
        is_causal=causal and window is None)[0]


def tensor_core_instructions(lib: Path) -> dict | None:
    """The HGMMA (wgmma) and HMMA (mma.sync) instructions in a built
    library's SASS, by ``cuobjdump -sass``; None where the toolkit has no
    ``cuobjdump``."""
    import re
    from repro_torch.kernels.build import toolkit_tool
    try:
        tool = toolkit_tool("cuobjdump")
    except RuntimeError:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("HGMMA", "HMMA")}


def bf16_reading(out, ref, q, k, v, live, **kw) -> float:
    """The largest |out - ref| / (2^-7 |ref| + 2^-8 sum_c p_c |v_c|) over
    the live rows: at most 1 where the kernel agrees with its plain
    version to bf16's roundings."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    mass = attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    ref = ref.float()[:, live]
    lim = FLASH_BF16_REL * ref.abs() + FLASH_BF16_P * mass[:, live]
    d = (out.float()[:, live] - ref).abs()
    return (d / lim.clamp_min(1e-30)).max().item()


def phase_flash_kernel(card):
    from repro_torch.kernels.build import lib_path
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
        ("Qwen3-0.6B prefill bf16", 32, 4096, 4096, 128, torch.bfloat16,
         True, None),
        # RecurrentGemma-9B's local attention (16 query heads, window 2048)
        ("RecurrentGemma hd 256", 16, 2048, 2048, 256, torch.float32, True,
         2048),
        ("RecurrentGemma hd 256 bf16", 16, 2048, 2048, 256, torch.bfloat16,
         True, 2048),
        # head dims padded to the next instantiation: DeepSeek-V3's MTP
        # block (128 heads of 56, B = 2, S = 511) and reduced nano-lm's 32
        ("DeepSeek-V3 MTP hd 56", 256, 511, 511, 56, torch.float32, True,
         None),
        ("DeepSeek-V3 MTP hd 56 bf16", 256, 511, 511, 56, torch.bfloat16,
         True, None),
        ("hd 32", 96, 1024, 1024, 32, torch.float32, True, None),
        ("hd 32 bf16", 96, 1024, 1024, 32, torch.bfloat16, True, None),
    ]
    lib = lib_path("flash_attention_bhsd")
    sass = tensor_core_instructions(lib)
    if sass is None:
        print(f"[{card}] flash_attention_bhsd SASS: not measured (no "
              f"cuobjdump)")
    else:
        require(sass["HGMMA"] > 0 and sass["HMMA"] > 0,
                f"flash kernel without tensor-core instructions: {sass}")
        print(f"[{card}] flash_attention_bhsd SASS ({lib.name}): "
              f"{sass['HGMMA']} HGMMA (wgmma: bf16, and Q.K^T at f32), "
              f"{sass['HMMA']} HMMA (mma.sync: P.V at f32)")
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
            reading = bf16_reading(out, ref, q, k, v, live, **kw)
            ok = err <= FLASH_BF16_ATOL and reading <= 1.0
            # a planted fault the gate must see: P V of the last 64 keys of
            # head 0 dropped, which only the 64 longest rows read
            vf = v.clone()
            vf[0, t_len - 64:] = 0
            bad = flash_attention_bhsd(q, k, vf, **kw)
            bad_err = (bad.float() - ref.float()).abs().max().item()
            bad_reading = bf16_reading(bad, ref, q, k, v, live, **kw)
            require(bad_reading > 1.0,
                    f"{label}: the bf16 gate passes a dropped k tile "
                    f"(reading {bad_reading:.3f})")
            tol = (f"atol {FLASH_BF16_ATOL:g}, and {reading:.3f} of the "
                   f"bound 2^-7 |ref| + 2^-8 sum p|v|; the last 64 keys of "
                   f"head 0 dropped read {bad_reading:.3f} of it, max abs "
                   f"err {bad_err:.3e}")
            del vf, bad
        require(ok, f"flash kernel disagrees with plain at {label}: {err} "
                    f"({tol})")
        del out, ref
        ms = cuda_ms(lambda: flash_attention_bhsd(q, k, v, **kw), reps=20)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), reps=5,
                           warmup=1)
        lib_ms = cuda_ms(lambda: library_attention(q, k, v, causal, window),
                         reps=20)
        pairs = bh * live_pairs(s_len, t_len, causal, window, dev)
        flops = 4 * hd * pairs
        nbytes = (2 * s_len + 2 * t_len) * bh * hd * q.element_size()
        # the route's bound: f32 runs 3 TF32 products for each product
        if dtype == torch.float32:
            route, route_flops, peak = "3xTF32", 3 * flops, PEAK_TF32_FLOPS
            core = bound(nbytes, flops, PEAK_F32_FLOPS)
            core_note = (f"; the CUDA-core f32 bound of earlier records "
                         f"{core['bound_ms']:.4f} ms ({flops / 1e9:.2f} "
                         f"GFLOP at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s)")
        else:
            route, route_flops, peak = "bf16 wgmma", flops, PEAK_BF16_FLOPS
            core_note = ""
        b = bound(nbytes, route_flops, peak)
        share = b["bound_ms"] / ms
        require(share <= 1.0, f"{label}: {ms:.4f} ms is below the "
                              f"{route} bound {b['bound_ms']:.4f} ms")
        print(f"[{card}] flash_attention_bhsd {label} ({bh}, {s_len}, "
              f"{hd}) T={t_len} {str(dtype)[6:]} causal={causal} "
              f"window={window}: max abs err {err:.3e} ({tol}); "
              f"{ms:.4f} ms (mean of 20); {route} bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({route_flops / 1e9:.2f} GFLOP at {peak / 1e12:g} TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} "
              f"TB/s), {share:.1%} of it{core_note}; "
              f"{flops / ms / 1e9:.2f} TFLOP/s of attention achieved; "
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
def misaligned(t, d, dtype, offset, gen):
    """A (t, d) view of a larger buffer that starts ``offset`` elements
    past a 16-byte boundary, as ``ops.rmsnorm`` hands the kernel a
    flattened view."""
    buf = torch.randn(t * d + offset, generator=gen, device="cuda").to(dtype)
    x = buf[offset:].view(t, d)
    require(x.data_ptr() % 16 != 0, "the view is 16-byte aligned")
    return x


def phase_rmsnorm_kernel(card):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_2d
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f32, bf16 = torch.float32, torch.bfloat16
    # (t, d, dtype, elements off a 16-byte boundary, timed): the size
    # classes (warp, block, long) with vectors; D not a multiple of the
    # vector width (7, 250 at bf16, 1001, 8193), element by element in each
    # class; views off a boundary (a head and a tail slot with vectors)
    cases = [(t, d, dt, 0, True) for t, d in ((8192, 768), (8192, 1024),
                                              (64, 8192), (16, 16384))
             for dt in (f32, bf16)]
    cases += [(t, d, dt, 0, False) for t, d in ((130, 768), (1, 256),
                                               (1, 7), (3, 1000))
              for dt in (f32, bf16)]
    cases += [(8192, 768, bf16, 3, True), (130, 768, f32, 1, False),
              (3, 1000, bf16, 5, False), (64, 8192, f32, 2, False),
              (16, 16384, bf16, 7, False), (5, 7, f32, 1, False),
              (3, 250, bf16, 0, False), (4, 1001, f32, 0, False),
              (4, 1001, bf16, 1, False), (2, 8193, bf16, 0, False),
              (2, 8193, f32, 3, False)]
    rows = {}
    for t, d, dtype, offset, timed in cases:
        x = misaligned(t, d, dtype, offset, gen) if offset else \
            torch.randn(t, d, generator=gen, device=dev).to(dtype)
        sc = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        out, ref = rmsnorm_2d(x, sc), rmsnorm_ref(x, sc)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = RMSNORM_F32_ATOL if dtype == f32 else RMSNORM_BF16_ATOL
        label = (f"({t}, {d}) {str(dtype)[6:]}"
                 + (f", {offset} elements off 16 B" if offset else ""))
        require(err <= tol, f"rmsnorm_2d disagrees with plain at {label}: "
                            f"{err}")
        require(out.data_ptr() % 16 == x.data_ptr() % 16,
                f"rmsnorm_2d's out is not aligned as x at {label}")
        if not timed:
            print(f"[{card}] rmsnorm_2d {label}: max abs err {err:.3e} "
                  f"(atol {tol:g})")
            continue
        # eagerly 200 launches: the host sets the pace here, and its time
        # varies more than the card's
        ms = cuda_ms(lambda: rmsnorm_2d(x, sc), reps=200)
        g_ms, _ = graph_ms(lambda: rmsnorm_2d(x, sc), calls=20)
        plain_ms = cuda_ms(lambda: rmsnorm_ref(x, sc), reps=20)
        weight = 1 + sc
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight, 1e-6),
                         reps=200)
        lib_g_ms, _ = graph_ms(lambda: F.rms_norm(x, (d,), weight, 1e-6),
                               calls=20)
        # the same bytes moved by PyTorch's copy into a fresh tensor, timed
        # the same way: what a read-once write-once pass reaches here
        copy_g_ms, _ = graph_ms(lambda: x.clone(), calls=20)
        nbytes = (2 * t * d + d) * x.element_size()
        b = bound(nbytes, 4 * t * d,
                  PEAK_F32_FLOPS if dtype == f32 else PEAK_BF16_FLOPS)
        print(f"[{card}] rmsnorm_2d {label}: max abs err {err:.3e} (atol "
              f"{tol:g}); eager {ms:.4f} ms (mean of 200), CUDA graph "
              f"{g_ms:.4f} ms (mean of 20 x 10), bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({nbytes / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} "
              f"TB/s; {b['bound_ms'] / ms:.1%} eager, "
              f"{b['bound_ms'] / g_ms:.1%} graph); F.rms_norm eager "
              f"{lib_ms:.4f} ms, graph {lib_g_ms:.4f} ms; x.clone() graph "
              f"{copy_g_ms:.4f} ms; plain {plain_ms:.4f} ms")
        rows[(t, d, dtype, offset)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": lib_ms}
    return rows[(8192, 768, f32, 0)]


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
    products = weight_products(cfg, base.batch_size, base.seq_len)
    require_products(launches, 2 * LM_ROUNDS * 3 * products, "the LM replay")
    n_params = sum(a[0].numel() for a in tree_leaves(runs["a2cid2"].state.x))
    require(n_params == NANO_PARAMS,
            f"nano-lm has {n_params} parameters, JAX's eval_shape "
            f"{NANO_PARAMS}")
    require(launches["mixing_gossip_stacked"] == 2 * comm_steps,
            f"clean kernel launched {launches['mixing_gossip_stacked']} "
            f"times, stream has {comm_steps} comm steps per arm")
    require(launches["tick_tail_stacked"] == 2 * LM_ROUNDS,
            f"the tick tail launched {launches['tick_tail_stacked']} times "
            f"for 2 x {LM_ROUNDS} gradient ticks")
    require(only_launched(launches, *CLEAN_REPLAY, DENSE),
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
              f"{[round(t, 4) for t in comm]} (earlier: "
              f"{EARLIER_LM_COMM_MS:.2f} ms), rest per round (pack, "
              f"tick tail, host) {rest:.2f} ms; peak memory "
              f"{peaks[arm] / 2**30:.2f} GiB")
    print(f"[{card}] LM replay: nano-lm full, {n_params} parameters, "
          f"{comm_steps} comm steps + {LM_ROUNDS} gradient ticks per arm; "
          f"mixing_gossip_stacked launches "
          f"{launches['mixing_gossip_stacked']} == 2 x {comm_steps}, "
          f"tick_tail_stacked {launches['tick_tail_stacked']} == 2 x "
          f"{LM_ROUNDS}, gemm_3xtf32 {launches[DENSE]} == 2 x {LM_ROUNDS} "
          f"ticks x 3 x {products} weight products, every other kernel 0")
    acid = runs["a2cid2"]
    return ({name: launches[name] for name in CLEAN_REPLAY}, acid.model.cfg,
            acid.stream, worker_mean(acid.state.x))


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
def kernel_gaps(cfg, params, batch, logits, xla_logits) -> dict:
    """max|d| / max|logit| of the pallas forward's ``logits`` against the
    same forward through the plain flash version (f32 scores, P unrounded),
    and of three controls against that reference: the xla path (scores
    rounded to bf16), and the kernel with P V of 64 keys dropped in every
    layer, the last 64 of head 0 ('last tile') or keys 2048-2111 of every
    head ('mid tile')."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import Model
    kernel = flash_ops.flash_attention_bhsd

    def dropping(heads, keys):
        def fn(q, k, v, **kw):
            v = v.clone()
            v[heads, keys] = 0
            return kernel(q, k, v, **kw)
        return fn

    pallas = make_prefill_step(Model(cfg.with_updates(
        attention_impl="pallas")))
    runs = {}
    for name, fn in (("plain", attention_ref),
                     ("last tile", dropping(0, slice(-64, None))),
                     ("mid tile", dropping(slice(None), slice(2048, 2112)))):
        flash_ops.flash_attention_bhsd = fn
        try:
            runs[name] = pallas(params, batch).float()
        finally:
            flash_ops.flash_attention_bhsd = kernel
    ref = runs.pop("plain")
    scale = ref.abs().max().item()
    runs = {"kernel": logits, "xla": xla_logits, **runs}
    return {name: (x.float() - ref).abs().max().item() / scale
            for name, x in runs.items()}


def check_prefill(card, label, cfg, params, tokens, n_attn, tol=MODEL_TOL,
                  controls=False):
    """Pallas vs xla prefill of one model on ``tokens`` (B, S+1): the flash
    launches of one forward, the logits' agreement (max|d| / max|logit| <
    ``tol``), the CE; with ``controls``, also the kernel's gap to the plain
    flash version below ``tol`` and the every-head tile fault's above it
    (``kernel_gaps``); returns the flash launches."""
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
    b, s = inputs.shape
    products = require_products(launches, weight_products(cfg, b, s), label)
    require(only_launched(launches, "flash_attention_bhsd", DENSE),
            f"{label}: another kernel launched in the prefill: {launches}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = xla(params, batch)
    torch.cuda.synchronize()
    xla_ms = (time.perf_counter() - t0) * 1e3
    scale = ref.float().abs().max().item()
    rel = (logits.float() - ref.float()).abs().max().item() / scale
    require(rel < tol, f"{label}: pallas vs xla logits "
                       f"max|d|/max|logit| = {rel:.3e}")
    gaps = ""
    if controls:
        g = kernel_gaps(cfg, params, batch, logits, ref)
        require(g["kernel"] < tol < g["mid tile"],
                f"{label}: against the plain flash version, the kernel's "
                f"logits read {g['kernel']:.3e} and a dropped tile of every "
                f"head {g['mid tile']:.3e}, the limit {tol:g}")
        gaps = ("; against the same forward through the plain flash "
                "version, max|d|/max|logit| " + ", ".join(
                    f"{name} {x:.3e}" for name, x in g.items())
                + f" (the kernel's < {tol:g} < the mid tile's)")
    v = cfg.padded_vocab
    ce = F.cross_entropy(logits.reshape(-1, v).float(),
                         labels.reshape(-1)).item()
    require(np.isfinite(ce), f"{label}: CE is not finite")
    print(f"[{card}] prefill {label} (B={b}, S={s}): flash launches "
          f"{launches['flash_attention_bhsd']} == {n_attn} attention layers,"
          f" gemm_3xtf32 {products} == the weight products, other kernels "
          f"0; logits vs the xla path max|d|/max|logit| "
          f"{rel:.3e} (< {tol:g}){gaps}; CE {ce:.4f}; forward "
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
    # bf16 weights and compute: the port, like torch, does not promote a
    # bf16 activation against f32 weights, so both are bf16 (the same draws
    # as above, rounded)
    del params
    torch.cuda.empty_cache()
    qwen16 = qwen.with_updates(param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = Model(qwen16).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    launches += check_prefill(card, "Qwen3-0.6B bf16", qwen16, params,
                              tokens, qwen.num_layers, tol=MODEL_BF16_TOL,
                              controls=True)
    print(f"[{card}] Qwen3-0.6B bf16: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
def foreach_event(xs, xts, xps, c, a, at):
    """mix then p2p on lists of leaves as a composition of eight
    ``torch._foreach_*`` calls, the plain version's operations in its
    order: a yardstick of the same arithmetic, not one library call."""
    d = torch._foreach_sub(xts, xs)
    cd = torch._foreach_mul(d, c)
    xm = torch._foreach_add(xs, cd)
    xtm = torch._foreach_sub(xts, cd)
    m = torch._foreach_sub(xm, xps)
    return (torch._foreach_sub(xm, torch._foreach_mul(m, a)),
            torch._foreach_sub(xtm, torch._foreach_mul(m, at)))


def leaves_equal(want, got) -> tuple[bool, float]:
    """(every leaf of two lists or trees bit for bit, the largest
    difference)."""
    from repro_torch.core.tree import tree_leaves
    want, got = tree_leaves(want), tree_leaves(got)
    err, same = 0.0, len(want) == len(got)
    for a, b in zip(want, got):
        same = same and a.shape == b.shape and torch.equal(a, b)
        if a.numel():
            err = max(err, (a.float() - b.float()).abs().max().item())
    return same, err


def wide_tree(gen, leaves: int):
    """Three lists of ``leaves`` leaves on the card, more than one launch
    holds: empty and one-element leaves, odd lengths up to 70,000, views 1
    and 3 elements past an aligned start, f32 and bf16 mixed."""
    xs, xts, xps = [], [], []
    for k in range(leaves):
        n = (0, 1, 2, 7, 127, 4099, 70_001)[k % 7] if k < 14 else int(
            torch.randint(0, 70_000, (), generator=gen, device="cuda"))
        off = (0, 1, 3)[k % 3]
        dtype = torch.bfloat16 if k % 4 == 1 else torch.float32
        for out in (xs, xts, xps):
            base = torch.randn(n + 8, generator=gen, device="cuda")
            out.append(base.to(dtype)[off:off + n])
    return xs, xts, xps


def host_split(xs, xts, xps, dt, dyn, calls: int = 40) -> dict:
    """Host microseconds of one ``gossip_event_pytree`` call on a
    one-dtype tree, and of its parts, each the median of 5 means of
    ``calls`` calls (``time.perf_counter_ns``; the card runs behind): the
    checks (which
    also read each leaf's addresses, length, shape and strides), the
    outputs (two buffers and a view a leaf), the table (``plan_launches``),
    the launch (the ctypes calls), and the rest (tree flatten and
    unflatten, dt, the device context and stream)."""
    from repro_torch.kernels.a2cid2_mixing import kernel as mk
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_pytree
    dtype, dev = xs[0].dtype, xs[0].device
    fn = mk._entry("mixing_p2p")
    stream = torch.cuda.current_stream().cuda_stream
    (leaves,) = mk._check_tree(xs, xts, xps, dt).values()
    # the launches write into these outputs: keep them alive
    outs = mk._tree_outputs(leaves, dtype, dev)
    launches = outs[2]
    rows = [tuple(int(v) for v in tuple(r)[:6]) for t, _ in launches
            for r in t]

    def mean_us(f) -> float:
        """The median of 5 means of ``calls`` calls (the host swings)."""
        f()
        means = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                f()
            means.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
        return float(np.median(means))

    out = {
        "call": mean_us(lambda: gossip_event_pytree(xs, xts, xps, dt,
                                                    **dyn)),
        "checks": mean_us(lambda: mk._check_tree(xs, xts, xps, dt)),
        "outputs": mean_us(lambda: mk._tree_outputs(leaves, dtype, dev)),
        "table": mean_us(lambda: mk.plan_launches(rows,
                                                  xs[0].element_size())),
        "launch": mean_us(lambda: mk._launch_tree(fn, dtype, launches, dt,
                                                  stream, **dyn))}
    # _tree_outputs plans the table too: its own share is outputs - table
    out["outputs"] -= out["table"]
    out["rest"] = out["call"] - sum(v for k, v in out.items() if k != "call")
    return out


def phase_mixing_p2p(card, params0, dyn):
    """16: ``mixing_p2p`` through ``gossip_event_pytree``: ONE launch a
    ResNet-18-CIFAR tree, f32 and bf16, bit for bit its plain version, also
    on odd and misaligned leaves and on a tree wider than a launch, and in a
    CUDA graph; its times beside the summed bound, the earlier per-leaf
    kernel's and a ``torch._foreach_*`` composition.  Returns (the row, the
    launches of the main-path call)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.a2cid2_mixing import kernel as mk
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_pytree
    from repro_torch.kernels.a2cid2_mixing.ref import _coeff, dtype_scalar
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def perturbed(tree):
        return tree_map(lambda a: a + 0.1 * torch.randn(
            a.shape, generator=gen, device=a.device), tree)

    x, xt, xp = params0, perturbed(params0), perturbed(params0)
    leaves = tree_leaves(x)
    n = sum(a.numel() for a in leaves)
    dt = torch.tensor(0.37, device="cuda")
    trees = {dtype: [tree_map(lambda a: a.to(dtype), t) for t in (x, xt, xp)]
             for dtype in (torch.float32, torch.bfloat16)}

    def launched(fn) -> tuple:
        before = mk.mixing_p2p.launches
        out = fn()
        torch.cuda.synchronize()
        return out, mk.mixing_p2p.launches - before

    err = 0.0
    for dtype, tree in trees.items():
        ref = gossip_event_pytree(*tree, dt, backend="ref", **dyn)
        got, count = launched(lambda: gossip_event_pytree(*tree, dt, **dyn))
        same, e = leaves_equal(ref, got)
        err = max(err, e)
        require(same and count == 1,
                f"mixing_p2p {dtype} on the ResNet tree: {count} launches, "
                f"bit for bit the plain version: {same}")
    # odd lengths, and views 1 and 3 elements past an aligned start: one
    # tree of them, and each alone
    for dtype in (torch.float32, torch.bfloat16):
        odd = [[torch.randn(length + 8, generator=gen, device="cuda").to(
            dtype)[off:off + length] for length, off in ODD_LEAVES]
            for _ in range(3)]
        ref = gossip_event_pytree(*odd, dt, backend="ref", **dyn)
        got, count = launched(lambda: gossip_event_pytree(*odd, dt, **dyn))
        alone = [mk.mixing_p2p(*leaf, dt, **dyn) for leaf in zip(*odd)]
        same = leaves_equal(ref, got)[0] and leaves_equal(
            ref, ([a for a, _ in alone], [b for _, b in alone]))[0]
        require(same and count == 1,
                f"mixing_p2p {dtype} on {ODD_LEAVES}: {count} launches, bit "
                f"for bit the plain version: {same}")
    # a tree wider than a launch: 2 * MAX_SEGMENTS + 3 leaves of both dtypes
    wide = wide_tree(gen, 2 * mk.MAX_SEGMENTS + 3)
    per_dtype: dict = {}
    for a in wide[0]:
        per_dtype[a.dtype] = per_dtype.get(a.dtype, 0) + (a.numel() > 0)
    want_launches = sum(-(-v // mk.MAX_SEGMENTS) for v in per_dtype.values())
    ref = gossip_event_pytree(*wide, dt, backend="ref", **dyn)
    got, count = launched(lambda: gossip_event_pytree(*wide, dt, **dyn))
    same = leaves_equal(ref, got)[0]
    require(same and count == want_launches,
            f"mixing_p2p on {len(wide[0])} leaves: {count} launches (want "
            f"{want_launches}), bit for bit the plain version: {same}")
    print(f"[{card}] mixing_p2p vs plain on the {len(leaves)} leaves of "
          f"the ResNet tree ({n} parameters, "
          f"{min(a.numel() for a in leaves)} to "
          f"{max(a.numel() for a in leaves)} a leaf) f32 and bf16, one "
          f"launch a tree: max abs err {err:.1e} (bit for bit); odd lengths "
          f"and views at element offsets 1 and 3 ({ODD_LEAVES}) as one tree "
          f"and alone, f32 and bf16: bit for bit; {len(wide[0])} leaves of "
          f"lengths 0 to 70,001, f32 and bf16 mixed, in {count} launches "
          f"(at most {mk.MAX_SEGMENTS} leaves a launch): bit for bit")
    del wide, ref, got
    reset_launches()
    gossip_event_pytree(x, xt, xp, dt, **dyn)     # the main-path call
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches["mixing_p2p"] == 1
            and only_launched(launches, "mixing_p2p"),
            f"gossip_event_pytree launched {launches}, want one mixing_p2p "
            f"and nothing else")
    print(f"[{card}] gossip_event_pytree on the ResNet tree f32: "
          f"{launches['mixing_p2p']} mixing_p2p launch and nothing else")
    row = {}
    for dtype, (tx, txt, txp) in trees.items():
        name = str(dtype)[6:]
        size = tree_leaves(tx)[0].element_size()
        # x, x~, xp read once, two outputs written once, dt once
        nbytes = 5 * n * size + 4
        b = bound(nbytes, FLOPS_PER_ELEM * n)
        call = lambda: gossip_event_pytree(tx, txt, txp, dt, **dyn)  # noqa
        # eagerly the host sets the pace, and it swings from run to run:
        # the median of 5 runs of 20 trees, and their range
        eager = [cuda_ms(call, reps=20) for _ in range(5)]
        ms = float(np.median(eager))
        want = call()
        g_ms, got = graph_ms(call, 1)
        torch.cuda.synchronize()
        require(leaves_equal(want, got)[0],
                f"mixing_p2p {name}: the graph-captured tree differs from "
                f"the eager one")
        del want, got
        lx, ltx, lxp = (tree_leaves(t) for t in (tx, txt, txp))
        c = _coeff(dyn["eta"], dt, dtype)
        a, at = (dtype_scalar(dyn[k], dtype) for k in ("alpha", "alpha_t"))
        fe = lambda: foreach_event(lx, ltx, lxp, c, a, at)  # noqa: E731
        fe_same, fe_err = leaves_equal(
            gossip_event_pytree(tx, txt, txp, dt, backend="ref", **dyn),
            list(fe()))
        fe_eager = [cuda_ms(fe, reps=20) for _ in range(5)]
        fe_ms = float(np.median(fe_eager))
        fe_graph_ms, _ = graph_ms(fe, 1)
        plain_ms = cuda_ms(lambda: gossip_event_pytree(
            tx, txt, txp, dt, backend="ref", **dyn), reps=5, warmup=1)
        print(f"[{card}] gossip_event_pytree on the ResNet tree {name}, "
              f"one launch: eager {ms:.4f} ms a tree (median of 5 runs of "
              f"20 trees, {min(eager):.4f} to {max(eager):.4f}; the earlier "
              f"per-leaf kernel's 56 launches {EARLIER_TREE_EAGER_MS:.4f} ms at f32), in a "
              f"CUDA graph {g_ms:.4f} ms a tree over 10 (the earlier "
              f"{EARLIER_TREE_GRAPH_MS:.4f} ms at f32; bit for bit the "
              f"eager tree); summed bound {b['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB; {b['bound_ms'] / g_ms:.1%} in the "
              f"graph, {b['bound_ms'] / ms:.1%} eagerly); the host is "
              f"{1 - g_ms / ms:.1%} of the eager tree; plain version "
              f"{plain_ms:.4f} ms; a torch._foreach_* composition of the "
              f"same arithmetic (8 calls over the {len(lx)} leaves, a "
              f"yardstick, not one library call) eager {fe_ms:.4f} ms "
              f"({min(fe_eager):.4f} to {max(fe_eager):.4f}), in "
              f"a graph {fe_graph_ms:.4f} ms, bit for bit the plain version:"
              f" {fe_same} (max abs err {fe_err:.1e}); library_ms null")
        row[name] = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                     "bound": b, "foreach_ms": fe_ms,
                     "foreach_graph_ms": fe_graph_ms}
    split = host_split(*(tree_leaves(t) for t in trees[torch.float32]), dt,
                       dyn)
    print(f"[{card}] host time of one gossip_event_pytree call on the f32 "
          f"ResNet tree (time.perf_counter_ns, median of 5 means of 40): "
          f"{split['call']:.1f} us = checks {split['checks']:.1f} + outputs "
          f"(2 buffers, {2 * len(leaves)} views) {split['outputs']:.1f} + "
          f"table {split['table']:.1f} + launch {split['launch']:.1f} + "
          f"rest (flatten, unflatten, dt, device context) "
          f"{split['rest']:.1f} us")
    # the kernel alone on the largest leaf, against its own bound
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    lx, lxt, lxp = (tree_leaves(t)[big] for t in (x, xt, xp))
    eager_leaf_ms = cuda_ms(lambda: mk.mixing_p2p(lx, lxt, lxp, dt, **dyn),
                            reps=20)
    leaf_ms, _ = graph_ms(lambda: mk.mixing_p2p(lx, lxt, lxp, dt, **dyn), 20)
    lb = bound(5 * lx.numel() * 4 + 4, FLOPS_PER_ELEM * lx.numel())
    print(f"[{card}] mixing_p2p alone on the largest leaf ({lx.numel()},) "
          f"f32, 20 launches in a CUDA graph: {leaf_ms:.4f} ms a launch, "
          f"bound {lb['bound_ms']:.4f} ms ({lb['bound_ms'] / leaf_ms:.1%}); "
          f"issued eagerly {eager_leaf_ms:.4f} ms a launch")
    f32 = row["float32"]
    return ({"max_abs_err": err, "ms": f32["ms"], "graph_ms": f32["graph_ms"],
             "plain_ms": f32["plain_ms"], "bound_ms": f32["bound"]["bound_ms"],
             "bound_by": f32["bound"]["bound_by"], "library_ms": None},
            launches["mixing_p2p"])


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


# ---------------------------------------- 19, 20: telemetry, run_world, AR
# ResNet-18-CIFAR's flat row: 11,171,274 f32 parameters
RESNET_ROW_BYTES = 44_685_096


def tree_equal(a, b) -> bool:
    """Every tensor leaf bit for bit (None leaves must match None)."""
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(la, lb))


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|: the LM tolerance's measure."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def twin_replays(make_state, run, spec) -> dict:
    """``run(state, telemetry)`` from two equal starts, with no spec and
    with ``spec``: {label: (final, trace, launches, host ms)}, each run's
    kernel launches counted from 0."""
    out = {}
    for label, tel in (("none", None), ("telemetry", spec)):
        state = make_state()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        final, trace = run(state, tel)
        torch.cuda.synchronize()
        out[label] = (final, trace, read_launches(),
                      (time.perf_counter() - t0) * 1e3)
        del state
    return out


def require_same_replay(runs: dict, what: str) -> None:
    """The telemetry run is bit for bit the run without a spec: final x,
    x~, every trace column and the defense trace, and the launches."""
    (fa, ta, la, _), (fb, tb, lb, _) = runs["none"], runs["telemetry"]
    require(ta.telemetry is None and tb.telemetry is not None,
            f"{what}: telemetry column missing or unasked")
    same = (tree_equal(fa.x, fb.x) and tree_equal(fa.x_tilde, fb.x_tilde)
            and all(torch.equal(getattr(ta, k), getattr(tb, k))
                    for k in ("loss", "consensus", "mean_param_norm")))
    if ta.defense is not None:
        same = same and all(torch.equal(u, v)
                            for u, v in zip(ta.defense, tb.defense))
    require(same, f"{what}: the telemetry replay is not bit for bit the "
                  f"replay without it")
    require(la == lb, f"{what}: launches differ with telemetry: {la} vs "
                      f"{lb}")


def budget_holds(tel) -> bool:
    """applied + rejected + dropped == scheduled, every round exactly."""
    total = (tel.applied + tel.rejected).cpu().numpy() + tel.dropped
    return bool(np.array_equal(total, tel.scheduled))


def stream_comm_steps(sched) -> int:
    from repro_torch.core import coalesce_schedule, coalesced_stream
    steps = coalesced_stream(coalesce_schedule(sched),
                             np.zeros(sched.n, np.float32))
    return int((~steps.is_grad).sum())


def stream_ticks(sched) -> int:
    """The gradient ticks of a schedule's compiled stream: the launches of
    the one-pass tick tail in a clean replay on the card."""
    from repro_torch.core import coalesce_schedule, coalesced_stream
    steps = coalesced_stream(coalesce_schedule(sched),
                             np.zeros(sched.n, np.float32))
    return int(steps.is_grad.sum())


def columns_agree(a, b, what: str) -> float:
    """Engine-against-oracle columns: counts exactly, moments within
    ENGINE_TOL relative; returns the largest moment error."""
    require(torch.equal(a.applied, b.applied)
            and torch.equal(a.rejected, b.rejected)
            and np.array_equal(a.scheduled, b.scheduled)
            and np.array_equal(a.stale_hist, b.stale_hist),
            f"{what}: telemetry counts differ")
    err = 0.0
    for k in ("norm_sum", "norm_sq_sum"):
        u, v = getattr(a, k), getattr(b, k)
        torch.testing.assert_close(u, v, rtol=ENGINE_TOL, atol=1e-6)
        err = max(err, ((u - v).abs() / v.abs().clamp_min(1e-30)).max()
                  .item())
    return err


def phase_telemetry(card, params0, cfg, stream_cls, grad_fn_for) -> dict:
    """19: ``Telemetry()`` on the card: (a) phase 5's hostile channel slice
    (static trim and defense arms), (b) phase 3's clean A2CiD2 arm, each
    bit for bit its replay without a spec; (c) engine columns against the
    per-event replay's on the quadratic; (d) phase 9's channel + defense
    worlds batch, bit for bit, and each world's columns against its serial
    replay's on the quadratic.  Returns the launches of the telemetry
    runs."""
    from repro_torch.core import (AdaptiveDefense, Algorithm, Simulator,
                                  Telemetry, World, make_schedule,
                                  params_from_graph, ring_graph,
                                  trace_summary)
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    hostile = hostile_channel(graph)
    grad = grad_fn_for(cfg, stream_cls(batch_size=BATCH))
    params = params_from_graph(graph, True)
    spec = Telemetry()
    out = {"channel_gossip_stacked": 0, "channel_gossip_worlds": 0}
    # warm-up: one model step outside the measured replays (the
    # deterministic cuDNN algorithms' set-up)
    warm = Simulator(grad, params, GAMMA).init(
        params0, N_WORKERS, torch.Generator(device=dev).manual_seed(9))
    grad(warm.x, warm.generator, torch.arange(N_WORKERS, device=dev))
    del warm

    def start(sim):
        return lambda: sim.init(params0, N_WORKERS, torch.Generator(
            device=dev).manual_seed(SEED + 1))

    # (a) the channel slice of phase 5
    sched = hostile.apply(make_schedule(graph, CHANNEL_ROUNDS,
                                        comms_per_grad=1.0,
                                        seed=CHANNEL_SEED),
                          seed=CHANNEL_SEED)
    comm_steps = stream_comm_steps(sched)
    sim = Simulator(grad, params, GAMMA, robust_clip=ROBUST_CLIP,
                    robust_rule="trim")
    for arm, defense in (("static trim", None),
                         ("defense", AdaptiveDefense())):
        runs = twin_replays(start(sim), lambda st, tel, d=defense:
                            sim.run_schedule(st, sched, defense=d,
                                             telemetry=tel), spec)
        require_same_replay(runs, f"channel {arm}")
        launched = runs["telemetry"][2]
        require(launched["channel_gossip_stacked"] == comm_steps
                and only_launched(launched, "channel_gossip_stacked"),
                f"channel {arm} with telemetry launched {launched}, the "
                f"stream has {comm_steps} comm steps")
        tel = runs["telemetry"][1].telemetry
        require(budget_holds(tel), f"channel {arm}: applied + rejected + "
                                   f"dropped != scheduled")
        require(tel.row_bytes == RESNET_ROW_BYTES,
                f"row_bytes {tel.row_bytes} != {RESNET_ROW_BYTES}")
        if defense is not None:
            require(float(tel.rejected.sum()) > 0,
                    "the defense arm's telemetry rejected nothing")
        wall_n, wall_t = runs["none"][3], runs["telemetry"][3]
        print(f"[{card}] 19a telemetry, channel {arm}: bit for bit the "
              f"replay without it (x, x~, loss, consensus"
              f"{', defense trace' if defense else ''}), launches equal "
              f"({launched['channel_gossip_stacked']} channel kernel); per "
              f"round applied {tel.applied.tolist()} rejected "
              f"{tel.rejected.tolist()} dropped {tel.dropped.tolist()} "
              f"scheduled {tel.scheduled.tolist()} (budget exact); "
              f"row_bytes {tel.row_bytes}; {trace_summary(tel)}")
        print(f"[{card}] 19a telemetry overhead, channel {arm}: replay "
              f"{wall_n:.1f} ms without, {wall_t:.1f} ms with: "
              f"{(wall_t - wall_n) / CHANNEL_ROUNDS:.2f} ms a round "
              f"(host clock, {CHANNEL_ROUNDS} rounds, {comm_steps} comm "
              f"steps)")
        out["channel_gossip_stacked"] += launched["channel_gossip_stacked"]
        del runs

    # (b) the clean A2CiD2 arm of phase 3: the spec forces the channel
    # flavour, the pinned reduction keeps it bit for bit
    sched = make_schedule(graph, ROUNDS, comms_per_grad=1.0, seed=SEED)
    comm_steps = stream_comm_steps(sched)
    sim = Simulator(grad, params, GAMMA)
    runs = twin_replays(start(sim), lambda st, tel: sim.run_schedule(
        st, sched, telemetry=tel), spec)
    (_, _, plain_l, wall_n), (_, tr, tel_l, wall_t) = \
        runs["none"], runs["telemetry"]
    require(plain_l["mixing_gossip_stacked"] == comm_steps
            and plain_l["tick_tail_stacked"] == stream_ticks(sched)
            and only_launched(plain_l, *CLEAN_REPLAY),
            f"clean replay launched {plain_l}")
    require(tel_l["channel_gossip_stacked"] == comm_steps
            and only_launched(tel_l, "channel_gossip_stacked"),
            f"clean replay with telemetry launched {tel_l}, expected the "
            f"channel kernel {comm_steps} times and nothing else")
    (fa, ta, _, _), (fb, tb, _, _) = runs["none"], runs["telemetry"]
    require(tree_equal(fa.x, fb.x) and tree_equal(fa.x_tilde, fb.x_tilde)
            and torch.equal(ta.loss, tb.loss),
            "clean slice: the telemetry replay (channel kernel) is not bit "
            "for bit the clean replay (clean kernel)")
    # the clean replay's row comes from tick_tail_stacked's sums, the
    # channel replay's from the eager ops: equal to the rounding of sums
    row_gap = max(rel_err(ta.consensus, tb.consensus),
                  rel_err(ta.mean_param_norm, tb.mean_param_norm))
    require(row_gap <= TICK_ROW_RTOL,
            f"clean slice: the rows part by {row_gap:.3e}")
    require(budget_holds(tr.telemetry)
            and float(tr.telemetry.rejected.sum()) == 0,
            "clean slice: budget or rejections wrong")
    print(f"[{card}] 19b telemetry, clean A2CiD2 arm: "
          f"channel_gossip_stacked {tel_l['channel_gossip_stacked']} == "
          f"{comm_steps} comm steps, mixing_gossip_stacked 0 (without the "
          f"spec: mixing_gossip_stacked {plain_l['mixing_gossip_stacked']}"
          f"); final state and losses bit for bit the clean replay's, "
          f"its row within {row_gap:.3e} (limit {TICK_ROW_RTOL:g}); replay "
          f"{wall_n:.1f} ms without, {wall_t:.1f} ms with: "
          f"{(wall_t - wall_n) / comm_steps:.2f} ms a comm step (host "
          f"clock); applied {tr.telemetry.applied.tolist()}")
    out["channel_gossip_stacked"] += tel_l["channel_gossip_stacked"]
    del runs

    # (c) engine against the per-event replay on the quadratic
    sched = hostile.apply(make_schedule(graph, 20, comms_per_grad=1.5,
                                        seed=SEED + 4), seed=SEED + 4)
    for flavour, defense in (("channel", None),
                             ("defense", AdaptiveDefense())):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        qsim, state = quadratic_sim(dev, gen, scale=0.1,
                                    robust_clip=ROBUST_CLIP)
        _, et = qsim.run_schedule(state, sched, defense=defense,
                                  telemetry=spec)
        _, rt = qsim.run_schedule(state, sched, defense=defense,
                                  telemetry=spec, engine=False)
        err = columns_agree(et.telemetry, rt.telemetry, flavour)
        print(f"[{card}] 19c telemetry engine vs per-event, {flavour} "
              f"(quadratic n=16 d=256, 20 rounds, hostile channel): "
              f"applied {int(et.telemetry.applied.sum())} rejected "
              f"{int(et.telemetry.rejected.sum())} equal exactly, moments "
              f"max rel err {err:.3e} (tolerance {ENGINE_TOL:g})")

    # (d) phase 9's channel + defense worlds batch in one call
    worlds, defenses, scheds = hostile_worlds(graph)
    comm_steps = worlds_comm_steps(scheds)
    sim = Simulator(grad, params, GAMMA)
    runs = twin_replays(
        lambda: worlds_states(sim, params0, SEED + 1),
        lambda st, tel: sim.run_worlds(
            st, scheds, worlds=worlds, robust_clips=[ROBUST_CLIP] * N_WORLDS,
            defenses=defenses, telemetry=tel), spec)
    require_same_replay(runs, "channel worlds")
    launched = runs["telemetry"][2]
    require(launched["channel_gossip_worlds"] == comm_steps
            and only_launched(launched, "channel_gossip_worlds"),
            f"worlds with telemetry launched {launched}")
    tel = runs["telemetry"][1].telemetry
    require(budget_holds(tel), "worlds: applied + rejected + dropped != "
                               "scheduled")
    require(all(float(tel.rejected[b].sum()) > 0 for b in (2, 3)),
            "a defense world's telemetry rejected nothing")
    wall_n, wall_t = runs["none"][3], runs["telemetry"][3]
    print(f"[{card}] 19d telemetry, B={N_WORLDS} channel + defense worlds "
          f"in one run_worlds call: bit for bit the batch without it, "
          f"channel_gossip_worlds {launched['channel_gossip_worlds']} == "
          f"{comm_steps} both ways; rejected per world "
          f"{tel.rejected.sum(dim=1).tolist()}, budget exact; replay "
          f"{wall_n:.1f} ms without, {wall_t:.1f} ms with: "
          f"{(wall_t - wall_n) / CHANNEL_ROUNDS:.2f} ms a round (host "
          f"clock)")
    out["channel_gossip_worlds"] += launched["channel_gossip_worlds"]
    del runs

    # each world's columns against its own serial replay's (quadratic)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    target = 0.1 * torch.randn(N_WORKERS, 256, generator=gen, device=dev)

    def quad(x, generator, ids):
        return 0.5 * ((x - target[ids]) ** 2).sum(dim=1), x - target[ids]

    qsim = Simulator(quad, params, GAMMA)
    qworlds = [World(topology=graph, channel=hostile,
                     algorithm=Algorithm(("adpsgd", "a2cid2")[b % 2]),
                     comms_per_grad=(1.0, 2.0, 1.5, 1.0)[b])
               for b in range(N_WORLDS)]
    qscheds = [w.compile(20, seed=SEED + 6 + b)
               for b, w in enumerate(qworlds)]
    gammas = [GAMMA, 0.5 * GAMMA, GAMMA, 2 * GAMMA]
    qdef = [None, AdaptiveDefense(), None, AdaptiveDefense()]

    def qstates():
        return [qsim.init(torch.zeros(256, device=dev), N_WORKERS,
                          torch.Generator(device=dev).manual_seed(b))
                for b in range(N_WORLDS)]

    _, trace = qsim.run_worlds(qstates(), qscheds, worlds=qworlds,
                               gammas=gammas,
                               robust_clips=[ROBUST_CLIP] * N_WORLDS,
                               defenses=qdef, telemetry=spec)
    err = 0.0
    for b in range(N_WORLDS):
        serial = dataclasses.replace(
            qsim, params=qworlds[b].algorithm_params(), gamma=gammas[b],
            robust_clip=ROBUST_CLIP)
        _, st = serial.run_schedule(qstates()[b], qscheds[b],
                                    defense=qdef[b], telemetry=spec)
        one = trace.telemetry._replace(**{
            k: getattr(trace.telemetry, k)[b] for k in (
                "applied", "rejected", "norm_sum", "norm_sq_sum",
                "scheduled", "stale_hist")})
        err = max(err, columns_agree(one, st.telemetry, f"world {b}"))
    print(f"[{card}] 19d worlds vs serial telemetry (quadratic n=16 d=256, "
          f"20 rounds, B={N_WORLDS}, two defense worlds): counts equal "
          f"exactly, moments max rel err {err:.3e} (tolerance "
          f"{ENGINE_TOL:g})")
    return out


def phase_run_world_ar(card, params0, cfg, stream_cls, grad_fn_for) -> int:
    """20: ``run_world`` bit for bit ``run_schedule`` of the compiled world
    (a clean ring world with a telemetry spec), and the AR-SGD baseline
    ``allreduce_sgd``; returns the channel kernel's launches of the
    ``run_world`` replay."""
    from repro_torch.core import (Simulator, Telemetry, World,
                                  allreduce_sgd, params_from_graph,
                                  ring_graph)
    from repro_torch.core.tree import tree_leaves
    dev = torch.device("cuda")
    graph = ring_graph(N_WORKERS)
    grad = grad_fn_for(cfg, stream_cls(batch_size=BATCH))
    sim = Simulator(grad, params_from_graph(graph, True), GAMMA)
    world = World(topology=graph, telemetry=Telemetry())
    sched = world.compile(ROUNDS, seed=SEED)
    comm_steps = stream_comm_steps(sched)
    runs = {}
    for label, run in (
            ("run_world", lambda st: sim.run_world(st, world, ROUNDS,
                                                   seed=SEED)),
            ("run_schedule", lambda st: sim.run_schedule(
                st, sched, telemetry=world.telemetry))):
        state = sim.init(params0, N_WORKERS,
                         torch.Generator(device=dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        final, trace = run(state)
        torch.cuda.synchronize()
        runs[label] = (final, trace, read_launches(),
                       (time.perf_counter() - t0) * 1e3)
        del state
    (fa, ta, la, wa), (fb, tb, lb, wb) = runs["run_world"], \
        runs["run_schedule"]
    require(tree_equal(fa.x, fb.x) and tree_equal(fa.x_tilde, fb.x_tilde)
            and all(torch.equal(getattr(ta, k), getattr(tb, k))
                    for k in ("loss", "consensus", "mean_param_norm"))
            and all(torch.equal(getattr(ta.telemetry, k),
                                getattr(tb.telemetry, k))
                    for k in ("applied", "rejected", "norm_sum",
                              "norm_sq_sum")),
            "run_world is not bit for bit run_schedule of its compile")
    require(la == lb and la["channel_gossip_stacked"] == comm_steps
            and only_launched(la, "channel_gossip_stacked"),
            f"run_world launched {la}, run_schedule {lb}")
    print(f"[{card}] 20 run_world(World(ring, telemetry=Telemetry()), "
          f"{ROUNDS}, seed={SEED}): bit for bit run_schedule of "
          f"world.compile (x, x~, trace, telemetry columns); "
          f"channel_gossip_stacked {la['channel_gossip_stacked']} == "
          f"{comm_steps} both; loss {ta.loss.tolist()}; {wa:.1f} / "
          f"{wb:.1f} ms (host clock)")
    del runs, fa, fb

    # AR-SGD: one batched gradient a round, the mean over the 16 workers
    marks, spread = [], []

    def timed_grad(x, generator, ids):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        # rows unequal anywhere (checked after the run, no host wait here)
        spread.append(torch.stack([(a != a[:1]).any()
                                   for a in tree_leaves(x)]).any())
        return grad(x, generator, ids)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    x_last, losses = allreduce_sgd(timed_grad, GAMMA, params0, N_WORKERS,
                                   ROUNDS, gen)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = read_launches()
    # the returned leaves are worker 0's rows of the final stacked state
    finals = [a._base for a in tree_leaves(x_last)]
    require(all(f is not None and f.shape[0] == N_WORKERS for f in finals),
            "allreduce_sgd's result is not a row of the stacked state")
    spread.append(torch.stack([(f != f[:1]).any() for f in finals]).any())
    require(not any(bool(s) for s in spread[1:]),
            f"AR-SGD rows differ after a round: {[bool(s) for s in spread]}")
    require(all(v == 0 for v in launched.values()),
            f"AR-SGD launched a gossip kernel: {launched}")
    require(losses.shape == (ROUNDS,) and bool(torch.isfinite(losses).all()),
            f"AR-SGD losses {losses.tolist()}")
    rounds_ms = [marks[r].elapsed_time((marks + [end])[r + 1])
                 for r in range(ROUNDS)]
    print(f"[{card}] 20 allreduce_sgd, ResNet-18-CIFAR, {N_WORKERS} workers "
          f"x {BATCH}, {ROUNDS} rounds: losses {losses.tolist()}; the "
          f"{N_WORKERS} rows bit for bit equal after every round; no "
          f"kernel launched; a round (gradient, mean, step; CUDA events) "
          f"{[round(t, 2) for t in rounds_ms]} ms, {wall:.1f} ms in all "
          f"(host clock)")
    return la["channel_gossip_stacked"]


# ------------------------------ 21: synchronous LM training, checkpoints
SYNC_STEPS, SYNC_TOL = 4, 1e-4   # the port's LM gradient tolerance


def phase_sync_train(card, stream) -> None:
    """21: ``launch.train.run_sync`` on nano-lm at full width and the CLI's
    defaults, 4 steps; the same 4 batches with ``remat=True`` and with 2
    micro-batches of 4 within SYNC_TOL of it; then the checkpoints."""
    from repro_torch.checkpoint import load_pytree, restore, save, \
        save_pytree
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.optim import Optimizer, sgd
    dev = torch.device("cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    tmp = Path(tmp_dir.name)
    args = train.build_parser().parse_args(
        ["--mode", "sync", "--full", "--arch", "nano-lm", "--steps",
         str(SYNC_STEPS), "--no-bayes-ce", "--ckpt", str(tmp / "sync")])
    timer = ReplayTimer()

    def timed_sgd():
        opt = sgd()
        return Optimizer(opt.init, timer.wrap("opt", opt.update))

    def timed_make(*a, **kw):
        step, opt = make_train_step(*a, **kw)
        return timer.wrap("step", step), opt

    peaks = {}   # (peak above the run's start, allocated at its start)

    def mark():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    orig = train.sgd, train.make_train_step
    train.sgd, train.make_train_step = timed_sgd, timed_make
    timer.arm = "plain"
    base = mark()
    reset_launches()
    try:
        run = train.run_sync(args, stream=stream)
    finally:
        train.sgd, train.make_train_step = orig
    peaks["plain"] = (torch.cuda.max_memory_allocated() - base, base)
    launched = read_launches()
    require_products(launched, SYNC_STEPS * 3 * weight_products(
        run.model.cfg, run.stream.batch_size, run.stream.seq_len),
        "the sync step")
    require(only_launched(launched, DENSE),
            f"the sync step launched a hand kernel: {launched}")
    n_params = sum(a.numel() for a in tree_leaves(run.state.params))
    require(n_params == NANO_PARAMS, f"nano-lm has {n_params} parameters")
    require(run.losses.shape == (SYNC_STEPS,)
            and bool(torch.isfinite(run.losses).all()),
            f"sync losses {run.losses.tolist()}")

    # the same batches: run_sync draws them from a generator seeded
    # seed + 1, one stream.sample a step
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batches = [stream.sample(gen) for _ in range(SYNC_STEPS)]
    model = run.model
    errs = {}
    for label, kw in (("remat", dict(remat=True)),
                      ("2 micro-batches", dict(remat=False,
                                               num_microbatches=2))):
        timer.arm = label
        base = mark()
        step, opt = timed_make(model, timed_sgd(), lr=args.lr, **kw)
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed))
        state = TrainState(params, opt.init(params))
        del params
        losses = []
        for b in batches:
            if "num_microbatches" in kw:
                b = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])
                     for k, v in b.items()}
            state, met = step(state, b)
            losses.append(met["loss"])
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - base, base)
        err = max([rel_err(torch.stack(losses), run.losses)]
                  + [rel_err(a, c) for a, c in zip(
                      tree_leaves(state.params),
                      tree_leaves(run.state.params))])
        require(err <= SYNC_TOL, f"{label}: losses or params differ from "
                                 f"the plain run by {err:.3e} > {SYNC_TOL}")
        errs[label] = (err, [round(float(v), 5) for v in losses])
        del state
    for label in ("plain", "remat", "2 micro-batches"):
        st, op = timer.ms(label, "step"), timer.ms(label, "opt")
        require(len(st) == SYNC_STEPS and len(op) == SYNC_STEPS,
                f"{label}: timed {len(st)} steps, {len(op)} updates")
        extra = "" if label == "plain" else (
            f"; losses {errs[label][1]}, max rel err vs plain "
            f"{errs[label][0]:.3e} (tolerance {SYNC_TOL:g})")
        print(f"[{card}] 21 sync {label}: step (CUDA events) "
              f"{[round(t, 2) for t in st]} ms = forward + backward "
              f"{[round(s - o, 2) for s, o in zip(st, op)]} + optimizer "
              f"{[round(o, 2) for o in op]} ms; peak memory "
              f"{peaks[label][0] / 2**30:.2f} GiB above the "
              f"{peaks[label][1] / 2**30:.2f} GiB allocated at its start "
              f"(the stream's (V, V) chain; for the later runs also the "
              f"plain run's state and the batches){extra}")
    print(f"[{card}] 21 run_sync nano-lm full ({n_params} parameters), "
          f"batch {args.batch_size} x {args.seq_len}, lr {args.lr}, sgd(), "
          f"{SYNC_STEPS} steps: losses {run.losses.tolist()}; "
          f"{run.seconds * 1e3:.1f} ms (host clock); no hand kernel "
          f"launched (xla attention path)")

    # checkpoints: the CLI's params, the whole TrainState, a bf16 copy,
    # retention, and run_sim's stacked replicas
    fresh = model.init(torch.Generator(device=dev).manual_seed(7))
    step_n, params = restore(str(tmp / "sync"), fresh)
    require(step_n == SYNC_STEPS and tree_equal(params, run.state.params),
            "--ckpt params do not reload bit for bit")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save(str(tmp / "state"), SYNC_STEPS, run.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    like = TrainState(fresh, sgd().init(fresh))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_n, back = restore(str(tmp / "state"), like)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(type(back) is TrainState and tree_equal(back, run.state),
            "restore into a fresh TrainState is not bit for bit")
    nbytes = sum(a.numel() * a.element_size()
                 for a in tree_leaves(run.state) if a is not None)
    bf16 = tree_map(lambda a: a.to(torch.bfloat16), run.state.params)
    save_pytree(str(tmp / "bf16.msgpack"), bf16)
    back16 = load_pytree(str(tmp / "bf16.msgpack"), bf16)
    require(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(tree_leaves(back16), tree_leaves(bf16))),
            "the bf16 tree does not round-trip bit for bit")
    for s in range(1, 6):
        save(str(tmp / "keep"), s, {"w": torch.full((4,), float(s),
                                                    device=dev)})
    kept = sorted(p.name for p in (tmp / "keep").iterdir())
    require(kept == [f"step_{s:08d}" for s in (3, 4, 5)],
            f"retention kept {kept}")
    sim_args = train.build_parser().parse_args(
        ["--full", "--arch", "nano-lm", "--workers", "2", "--steps", "2",
         "--no-bayes-ce", "--ckpt", str(tmp / "sim")])
    sim_run = train.run_sim(sim_args, stream=stream)
    step_n, x = restore(str(tmp / "sim"), sim_run.state.x)
    require(step_n == 2 and tree_equal(x, sim_run.state.x),
            "run_sim --ckpt's stacked x does not reload bit for bit")
    sim_bytes = (tmp / "sim" / "step_00000002" / "state.msgpack").stat() \
        .st_size
    print(f"[{card}] 21 checkpoints: --ckpt params restore bit for bit into "
          f"a fresh tree; the TrainState ({nbytes / 1e9:.3f} GB) saves in "
          f"{save_ms:.1f} ms and restores bit for bit in {load_ms:.1f} ms "
          f"(host clock, card to file and back); a bf16 copy round-trips "
          f"bit for bit; retention keeps {kept} of 5 saves; run_sim "
          f"--ckpt (2 workers, 2 rounds) wrote the stacked x "
          f"({sim_bytes / 1e9:.3f} GB), reloaded bit for bit")
    del sim_run, run
    tmp_dir.cleanup()


# ------------------------------ 22-24: the serving path (no hand kernel)
# 22: the serve CLI's defaults (launch/serve.py), Qwen3-0.6B at full width
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 32
DECODE_TOL = 2e-4   # decode vs forward logits (the JAX test_decode.py's)
# 23: 8 requests of mixed lengths on 4 slots of 128 rows
BATCH_SLOTS, BATCH_LEN, BATCH_REQUESTS = 4, 128, 8
# 24: the JAX serve bench's physics (benchmarks/run.py, _SERVE_BENCH) on 4
# replicas of nano-lm at full width, 12 rounds, one replica killed at
# round 4 in the churn arm
FLEET_REPLICAS, FLEET_ROUNDS, FLEET_SEED, FLEET_KILL = 4, 12, 0, 4
FLEET_LOAD = dict(rate=1.2, prompt_len=(3, 6), gen_len=(4, 10),
                  arrive_frac=0.55)
FLEET_KW = dict(max_batch=4, max_len=24, drift_scale=0.02,
                stall_per_event=0.03)


def require_no_hand_kernel(what: str, products: int = 0) -> None:
    """Nothing launched but ``products`` weight products (a decode step's
    rows, a bf16 model: none)."""
    launched = read_launches()
    require_products(launched, products, what)
    require(only_launched(launched, DENSE),
            f"{what} launched a hand kernel: {launched}")


def device_busy(fn) -> tuple:
    """(ms the card was busy running ``fn``'s kernels and copies, summed
    from ``torch.profiler``'s device events, or None where it recorded
    none; the host-clock ms of the profiled call, card synchronised).
    The profiler's own host cost lengthens the call, so the idle share
    read from the two is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return (busy or None), wall


def busy_text(busy, wall, what: str) -> str:
    if busy is None:
        return f"{what}: device busy share not measured (the profiler " \
               f"recorded no device event; {wall:.1f} ms host clock)"
    return f"{what}: the card busy {busy:.2f} of {wall:.2f} ms " \
           f"(torch.profiler), idle share at most {1 - busy / wall:.3f}"


def weights_bytes(params) -> int:
    from repro_torch.core.tree import tree_leaves
    return sum(a.numel() * a.element_size() for a in tree_leaves(params))


def timed_generate(model, params, prompts, gen):
    """``serve.generate`` with each ``decode_step`` timed by CUDA events:
    (ids, prefill ms, the decode steps' ms, host seconds)."""
    from repro_torch.launch.serve import generate
    timer = ReplayTimer()
    timer.arm = "generate"
    object.__setattr__(model, "decode_step",
                       timer.wrap("decode", model.decode_step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ids = generate(model, params, prompts, gen)
        torch.cuda.synchronize()
    finally:
        object.__delattr__(model, "decode_step")
    wall = time.perf_counter() - t0
    events = timer.events[("generate", "decode")]
    p_len = prompts.shape[1]
    require(len(events) == p_len + gen - 1,
            f"generate took {len(events)} decode steps")
    prefill_ms = events[0][0].elapsed_time(events[p_len - 1][1])
    return ids, prefill_ms, [s.elapsed_time(e) for s, e in
                             events[p_len:]], wall


def phase_decode(card, cfg, dev=None):
    """22: ``serve.generate`` on ``cfg`` (Qwen3-0.6B at full width) at the
    CLI's defaults, greedy: the decode logits of the prompt positions
    against ``Model.forward`` (xla) within DECODE_TOL, ``generate``'s ids
    the token-by-token loop's, a (B,) position vector bit for bit the
    duplicated-row references; prefill and decode timed by CUDA events.
    Returns (model, params, a decode step's mean ms)."""
    from repro_torch.models.transformer import Model
    dev = dev or torch.device("cuda")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    nbytes = weights_bytes(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    vocab = cfg.vocab_size

    # the timed run: generate with decode_step timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    ids, prefill_ms, steps, wall = timed_generate(model, params, prompts,
                                                  SERVE_GEN)
    require_no_hand_kernel("generate")
    peak = torch.cuda.max_memory_allocated() - base
    require(tuple(ids.shape) == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
            and torch.equal(ids[:, :SERVE_PROMPT], prompts)
            and int(ids.min()) >= 0 and int(ids.max()) < vocab,
            f"generate's ids {tuple(ids.shape)} out of range or shape")

    # the prompt positions against the forward, then the token loop
    with torch.no_grad():
        full, _, _ = model.forward(params, prompts)
        caches = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
        outs = []
        for t in range(SERVE_PROMPT):
            lg, caches = model.decode_step(params, prompts[:, t:t + 1], t,
                                           caches)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        rel = ((dec - full).abs().max() / full.abs().max()).item()
        require(rel < DECODE_TOL, f"decode vs forward {rel:.3e} >= "
                                  f"{DECODE_TOL}")
        loop = [prompts]
        for t in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN):
            cur = lg[:, 0, :vocab].argmax(-1)[:, None]
            loop.append(cur)
            lg, caches = model.decode_step(params, cur, t, caches)
        loop = torch.cat(loop, dim=1)
        require(torch.equal(ids, loop),
                f"generate's ids differ from the token loop's in "
                f"{int((ids != loop).sum())} places")
        del full, dec, caches

        # per-slot positions: row 0 at 5, row 1 at 2 in one batch, bit for
        # bit references at the same batch shape (rows duplicated)
        t_ids = torch.randint(0, vocab, (6,), generator=gen, device=dev)
        u_ids = torch.randint(0, vocab, (3,), generator=gen, device=dev)

        def duo(stream):
            c = model.init_cache(2, 16)
            for i, tok in enumerate(stream):
                out, c = model.decode_step(params, tok.repeat(2, 1), i, c)
            return out

        ref_a, ref_b = duo(t_ids[:, None]), duo(u_ids[:, None])
        c = model.init_cache(2, 16)
        for i in range(6):
            j = min(i, 2)
            out, c = model.decode_step(
                params, torch.stack([t_ids[i], u_ids[j]])[:, None],
                torch.tensor([i, j], dtype=torch.int32, device=dev), c)
        require(torch.equal(out[0], ref_a[0]) and torch.equal(out[1],
                                                              ref_b[1]),
                "a (B,) position vector is not bit for bit the "
                "duplicated-row references")

        def four_steps():
            c = model.init_cache(SERVE_BATCH, SERVE_PROMPT)
            for t in range(4):
                _, c = model.decode_step(params, prompts[:, t:t + 1], t, c)

        four_steps()
        busy = busy_text(*device_busy(four_steps), "4 decode steps")
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    n_new = SERVE_BATCH * SERVE_GEN
    print(f"[{card}] 22 decode {cfg.name} ({model.param_count(params)} "
          f"parameters, {nbytes / 1e9:.3f} GB f32, seed {SEED}), batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}, greedy: "
          f"decode vs forward {rel:.3e} (tolerance {DECODE_TOL:g}); "
          f"generate's ids the token loop's; a (B,) position vector bit "
          f"for bit the duplicated-row references; no hand kernel")
    print(f"[{card}] 22 prefill ({SERVE_PROMPT} decode steps, CUDA events) "
          f"{prefill_ms:.2f} ms; decode a step (CUDA events, "
          f"{len(steps)} steps) mean {np.mean(steps):.3f} ms, min "
          f"{min(steps):.3f}, max {max(steps):.3f} beside the weight-read "
          f"bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB / 3.35 TB/s); "
          f"{n_new} tokens in {wall * 1e3:.1f} ms (host clock) = "
          f"{n_new / wall:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          f"allocated at its start; {busy}")
    return model, params, float(np.mean(steps))


def phase_batching(card, model, params, dev=None):
    """23: ``ContinuousBatcher`` with BATCH_SLOTS slots of BATCH_LEN rows
    on BATCH_REQUESTS requests of 8-40 prompt and 8-32 new tokens: each
    finishes with exactly ``max_new`` ids, each equal to its own
    ``generate``; steps, slot occupancy and ms a step."""
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.launch.serve import generate
    dev = dev or torch.device("cuda")
    rng = np.random.default_rng(SEED + 23)
    vocab = model.cfg.vocab_size
    reqs = [Request(uid, rng.integers(0, vocab, int(rng.integers(8, 41))
                                      ).astype(np.int32),
                    int(rng.integers(8, 33)))
            for uid in range(BATCH_REQUESTS)]
    batcher = ContinuousBatcher(model, params, max_batch=BATCH_SLOTS,
                                max_len=BATCH_LEN)
    timer = ReplayTimer()
    timer.arm = "batch"
    batcher._step = timer.wrap("step", batcher._step)
    for r in reqs:
        batcher.submit(r)
    admitted, steps, active = {}, 0, 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        n = batcher.step()
        if n == 0 and not batcher.scheduler.queue:
            break
        for slot in batcher.scheduler.slots:
            if slot.req is not None:
                admitted.setdefault(slot.req.uid, steps)
        steps += 1
        active += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_no_hand_kernel("the batcher")
    require(all(r.done and len(r.out) == r.max_new for r in reqs),
            "a request did not finish with exactly max_new ids")
    require(sorted(set(admitted.values()))[-1] > 0,
            f"no staggered admission: {admitted}")
    step_ms = timer.ms("batch", "step")
    for r in reqs:
        ref = generate(model, params, torch.from_numpy(r.prompt).to(dev)
                       [None].long(), r.max_new)
        want = ref[0, len(r.prompt):].tolist()
        require(r.out == want, f"request {r.uid}: the batcher's ids differ "
                               f"from its own generate's")
    print(f"[{card}] 23 ContinuousBatcher {model.cfg.name}, "
          f"{BATCH_SLOTS} slots x {BATCH_LEN} rows, {BATCH_REQUESTS} "
          f"requests (prompt, new) "
          f"{[(len(r.prompt), r.max_new) for r in reqs]}, admitted at steps "
          f"{[admitted[r.uid] for r in reqs]}: every request finished with "
          f"exactly max_new ids, each its own generate's; {steps} steps, "
          f"slot occupancy {active / (steps * BATCH_SLOTS):.3f}; a step "
          f"(CUDA events) mean {np.mean(step_ms):.3f} ms, min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}; "
          f"{sum(r.max_new for r in reqs)} tokens in {wall * 1e3:.1f} ms "
          f"(host clock); no hand kernel")


def fleet_breakdown(tracer, timer, arm) -> tuple:
    """Per scheduled round: gossip and decode ms (CUDA events) and the
    host rest (the round's host-clock span minus both)."""
    rounds = [e["dur"] / 1e3 for e in tracer.events
              if e.get("name") == "fleet.round"]
    gossip = timer.ms(arm, "gossip")
    decode = timer.ms(arm, "decode")
    dec_r = [0.0] * len(rounds)
    decode_rounds = [e["args"]["round"] for e in tracer.events
                     if e.get("name") == "fleet.decode"]
    for r, ms in zip(decode_rounds, decode):
        if r < len(rounds):
            dec_r[r] = ms
    rest = [w - g - d for w, g, d in zip(rounds, gossip, dec_r)]
    drain = [ms for r, ms in zip(decode_rounds, decode) if r >= len(rounds)]
    return gossip[:len(rounds)], dec_r, rest, drain


def phase_fleet(card, cfg, dev=None):
    """24: ``GossipFleet`` on ``cfg`` (nano-lm at full width), 4 replicas
    on a ring, A2CiD2, delay horizon 2 / prob 0.3, drop 0.1, the serve
    bench's load, drift 'perturb' at 0.02, stall 0.03 an event, 12 rounds
    and the drain.  Arms: lossy (bank and consensus prefix bit for bit
    ``run_schedule(engine=False)``, nothing lost), churn (a replica killed
    at round 4: nothing lost, a restart), drift off with a stall of 1.0 an
    event (the bank unchanged, every request's ids ``generate``'s)."""
    from repro_torch.analysis import SpanTracer
    from repro_torch.core import (Algorithm, ChannelModel, DelayProcess,
                                  PhaseSwitch, ServeLoad, World, ring_graph)
    from repro_torch.core.simulator import SimState, Simulator
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.fleet import GossipFleet
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Model
    dev = dev or torch.device("cuda")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    nbytes = weights_bytes(params)
    base = dict(topology=ring_graph(FLEET_REPLICAS),
                algorithm=Algorithm("a2cid2"),
                channel=ChannelModel(delay=DelayProcess(horizon=2, prob=0.3),
                                     drop_prob=0.1),
                serve=ServeLoad(**FLEET_LOAD))
    kill = tuple(w != FLEET_REPLICAS - 1 for w in range(FLEET_REPLICAS))
    arms = [
        ("lossy", World(**base), dict(drift="perturb")),
        ("churn", World(**base, faults=(PhaseSwitch(FLEET_KILL,
                                                    active=kill),)),
         dict(drift="perturb")),
        ("drift off, stall 1.0", World(**base),
         dict(drift="none", stall_per_event=1.0)),
    ]
    timer = ReplayTimer()
    orig = Simulator._round_channel
    # the round's host span then holds its gossip, also on rounds where no
    # decode (which waits for the card) follows
    Simulator._round_channel = timer.wrap("gossip", orig, sync=True)
    try:
        for arm, world, kw in arms:
            fleet = GossipFleet(model, params, world, **{**FLEET_KW, **kw})
            fleet._decode_step = timer.wrap("decode", fleet._decode_step)
            tracer = SpanTracer(f"fleet {arm}")
            timer.arm = arm
            reset_launches()
            torch.cuda.synchronize()
            rep = fleet.run(rounds=FLEET_ROUNDS, seed=FLEET_SEED,
                            tracer=tracer)
            torch.cuda.synchronize()
            require_no_hand_kernel(f"the fleet ({arm})")
            require(rep.lost == 0 and rep.requests_total > 0,
                    f"{arm}: lost {rep.lost} of {rep.requests_total}")
            require(all(q.done and len(q.out) == q.max_new
                        for q in rep.completed),
                    f"{arm}: a request finished short")
            require(bool(np.isfinite(rep.consensus).all()),
                    f"{arm}: consensus {rep.consensus}")
            gossip, dec, rest, drain_dec = fleet_breakdown(tracer, timer,
                                                           arm)
            if arm == "lossy":
                timer.arm = "check"
                state = SimState(fleet._bank0, fleet._bank0.clone(),
                                 torch.zeros(FLEET_REPLICAS, device=dev),
                                 torch.Generator(device=dev).manual_seed(
                                     FLEET_SEED))
                out, trace = fleet.sim.run_schedule(
                    state, world.compile(FLEET_ROUNDS, FLEET_SEED),
                    engine=False)
                require(torch.equal(rep.final_bank, out.x),
                        "the fleet's bank is not bit for bit "
                        "run_schedule(engine=False)'s")
                require(np.array_equal(
                    rep.consensus[:rep.rounds],
                    trace.consensus.cpu().numpy().astype(np.float64)),
                        "the fleet's consensus is not run_schedule's")
                require(not torch.equal(rep.final_bank, fleet._bank0),
                        "the lossy arm's bank did not drift")
                del out, trace
                # the card's busy share: the same 12 gossip rounds, then 4
                # decode steps of the fleet (every slot active)
                gossip_busy = busy_text(*device_busy(
                    lambda: fleet.sim.run_schedule(
                        state, world.compile(FLEET_ROUNDS, FLEET_SEED),
                        engine=False)), f"{FLEET_ROUNDS} gossip rounds")
                del state
                caches = tree_map(lambda a: a.unsqueeze(0).repeat(
                    (FLEET_REPLICAS,) + (1,) * a.dim()), fleet._caches0)
                shape = (FLEET_REPLICAS, FLEET_KW["max_batch"])
                toks = torch.ones(shape + (1,), dtype=torch.int32,
                                  device=dev)
                act = torch.ones(shape, dtype=torch.bool, device=dev)

                def four_steps():
                    c = caches
                    for t in range(4):
                        _, c = fleet._decode_step(
                            rep.final_bank, c, toks,
                            torch.full(shape, t, dtype=torch.int32,
                                       device=dev), act)

                decode_busy = busy_text(*device_busy(four_steps),
                                        "4 fleet decode steps")
                del caches
                extra = ("; final bank and consensus prefix bit for bit "
                         f"run_schedule(engine=False)'s; {gossip_busy}; "
                         f"{decode_busy}")
            elif arm == "churn":
                require(rep.restarted >= 1, "the kill caught no request "
                                            "in flight")
                extra = f"; replica {FLEET_REPLICAS - 1} killed at round " \
                        f"{FLEET_KILL}, {rep.restarted} restarted"
            else:
                require(rep.stall_skips > 0, "no stall happened")
                require(torch.equal(rep.final_bank, fleet._bank0),
                        "the drift-off bank moved")
                for q in rep.completed:
                    ref = generate(model, params, torch.from_numpy(
                        q.prompt).to(dev)[None].long(), q.max_new)
                    require(q.out == ref[0, len(q.prompt):].tolist(),
                            f"request {q.uid}: the fleet's ids differ "
                            f"from generate's")
                extra = ("; the bank unchanged bit for bit and every "
                         "request's ids generate's")
            s = rep.summary()
            print(f"[{card}] 24 fleet {arm}: {cfg.name} "
                  f"({nbytes / 1e9:.3f} GB a replica, bank "
                  f"({FLEET_REPLICAS}, {fleet.layout.d}) f32), "
                  f"{rep.rounds} rounds + {rep.drain_rounds} drain, "
                  f"{rep.requests_total} requests, lost {rep.lost}, "
                  f"restarted {rep.restarted}, stall skips "
                  f"{rep.stall_skips}, {rep.tokens_generated} tokens in "
                  f"{rep.wall_seconds * 1e3:.1f} ms (host clock) = "
                  f"{s['tokens_per_second']:.1f} tokens/s, latency p50 / "
                  f"p95 {s['latency_p50']:.1f} / {s['latency_p95']:.1f} "
                  f"rounds, consensus final {s['consensus_final']:.4e}; no "
                  f"hand kernel{extra}")
            print(f"[{card}] 24 fleet {arm}, a scheduled round: gossip "
                  f"(_round_channel, CUDA events) "
                  f"{[round(v, 2) for v in gossip]} ms, decode (CUDA "
                  f"events) {[round(v, 2) for v in dec]} ms, host rest "
                  f"{[round(v, 2) for v in rest]} ms; a drain round's "
                  f"decode mean "
                  f"{np.mean(drain_dec) if drain_dec else float('nan'):.2f}"
                  f" ms")
            del fleet, rep
            torch.cuda.empty_cache()
    finally:
        Simulator._round_channel = orig


# ---------------------------- 25-27: the rest of the model zoo on the card
# 25: DeepSeek-V3 at published widths, cut from 61 layers to 2 (one MLA +
# dense layer, one MLA + MoE layer), MTP on, bf16 (jax.eval_shape count of
# the same cut)
DEEPSEEK_PARAMS = 14_648_806_400
ZOO_BATCH, ZOO_SEQ = 2, 512         # the loss's batch
# 26: the full configs, f32 (jax.eval_shape counts)
MAMBA_PARAMS, RGEMMA_PARAMS = 780_382_464, 9_396_408_320
MAMBA_DECODE_SEQ, MAMBA_PROMPT, MAMBA_GEN = 256, 16, 16
RGEMMA_DECODE_SEQ, RGEMMA_PREFILL = 64, 2048
# 27: the four families reduced, f32
ZOO_ARCHS = ("deepseek-v3-671b", "arctic-480b", "mamba2-780m",
             "recurrentgemma-9b")
ZOO_TRAIN_STEPS, ZOO_LR = 8, 0.05
# lm_grad_fn's vmapped gradients against separate grad_and_value calls,
# max|d| / max|grad| over the tree: 1e-6 in f64, where only a wrong
# function could part them; in f32 the repo's LM gradient tolerance
# (ROADMAP's parity contract), since vmap batches every matmul into
# cuBLAS's batched GEMMs, which sum in another order (1.296e-06 on
# reduced DeepSeek-V3 on an H100, PERF.md section 6)
ZOO_GRAD_TOL = {torch.float64: 1e-6, torch.float32: 1e-4}


class MoEProbe:
    """Inside ``with``: the MoE's dispatch, expert products and combine
    (``models.layers``) timed by CUDA events under ``timer.arm``, and each
    dispatch's keep mask kept (drops are its False entries)."""

    NAMES = {"_dispatch_group": "dispatch", "_expert_products": "experts",
             "_combine_group": "combine"}

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.timer, self.keeps = layers, ReplayTimer(), []
        self.orig = {n: getattr(layers, n) for n in self.NAMES}

    def __enter__(self):
        for name, kind in self.NAMES.items():
            setattr(self.layers, name, self.timer.wrap(kind,
                                                       self.orig[name]))
        timed = self.layers._dispatch_group

        def dispatch(*args):
            out = timed(*args)
            self.keeps.append(out[2])
            return out

        self.layers._dispatch_group = dispatch
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.layers, name, fn)

    def dropped(self) -> tuple[int, int]:
        """(picks dropped at capacity, picks) over the kept masks."""
        total = sum(k.numel() for k in self.keeps)
        return total - sum(int(k.sum()) for k in self.keeps), total

    def ms(self, kind) -> float:
        return sum(self.timer.ms(self.timer.arm, kind))


def token_loop(model, params, prompts, gen):
    """Greedy ids from a plain loop of ``decode_step``s, the reference of
    ``generate``."""
    b, p_len = prompts.shape
    vocab = model.cfg.vocab_size
    with torch.no_grad():
        caches = model.init_cache(b, p_len + gen)
        for t in range(p_len):
            lg, caches = model.decode_step(params, prompts[:, t:t + 1], t,
                                           caches)
        out = [prompts]
        for t in range(p_len, p_len + gen):
            cur = lg[:, 0, :vocab].argmax(-1)[:, None].to(prompts.dtype)
            out.append(cur)
            if t < p_len + gen - 1:
                lg, caches = model.decode_step(params, cur, t, caches)
    return torch.cat(out, dim=1)


def decode_vs_forward(model, params, tokens):
    """max|decode - forward| / max|forward| of the logits at every position
    of ``tokens`` (B, S), each decode step timed by CUDA events; returns
    (that ratio, the steps' ms, the final caches)."""
    timer = ReplayTimer()
    step = timer.wrap("decode", model.decode_step)
    b, s = tokens.shape
    with torch.no_grad():
        full, _, _ = model.forward(params, tokens)
        caches = model.init_cache(b, s)
        outs = []
        for t in range(s):
            lg, caches = step(params, tokens[:, t:t + 1], t, caches)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1).float()
        full = full.float()
        rel = ((dec - full).abs().max() / full.abs().max()).item()
    return rel, timer.ms("warm-up", "decode"), caches


def phase_deepseek(card):
    """25: DeepSeek-V3 at published widths, cut to 2 layers, bf16: ``loss``
    (ce, aux, mtp) with the MoE's drops and its time split, then
    ``generate`` against the token loop, the MLA cache's size and the
    decode step beside its weight-read bound.  No hand kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Block
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.transformer import Model
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v3-671b").with_updates(
        blocks=(((Block("mla", "dense"),), 1), ((Block("mla", "moe"),), 1)),
        param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = model.param_count(params)
    require(n_params == DEEPSEEK_PARAMS, f"DeepSeek-V3 (2 layers) has "
                                         f"{n_params} parameters, JAX's "
                                         f"{DEEPSEEK_PARAMS}")
    nbytes = weights_bytes(params)
    moe_p = params["groups"][1]["b0"]["mlp"]
    expert_bytes = sum(moe_p[k].numel() * moe_p[k].element_size()
                       for k in ("moe_up", "moe_gate", "moe_down"))
    # a decode step reads every weight but the embedding table and the MTP
    # block (the JAX package's design: the experts' products run on the
    # whole (E, C, D) buffer)
    step_bytes = (nbytes - weights_bytes(params["embed"])
                  - weights_bytes(params["mtp"]))
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    toks = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_SEQ + 1),
                         generator=gen, device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad(), MoEProbe() as probe:
        loss, met = model.loss(params, batch)
        torch.cuda.synchronize()
        probe.keeps.clear()
        probe.timer.arm = "forward"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.forward(params, batch["inputs"])
        end.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(end)
        dropped, picks = probe.dropped()
        split = {kind: probe.ms(kind)
                 for kind in ("dispatch", "experts", "combine")}
    loss_peak = torch.cuda.max_memory_allocated()
    require_no_hand_kernel("DeepSeek-V3's loss")
    ce, aux, mtp = (met[k].item() for k in ("ce", "aux", "mtp"))
    require(all(np.isfinite((ce, aux, mtp, loss.item()))) and aux > 0,
            f"DeepSeek-V3 loss: ce {ce}, aux {aux}, mtp {mtp}")
    require(picks == ZOO_BATCH * ZOO_SEQ * cfg.moe.top_k,
            f"the forward dispatched {picks} picks")
    print(f"[{card}] 25 DeepSeek-V3 at published widths (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads, q/kv ranks "
          f"{cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.num_experts} experts x {cfg.moe.d_expert} top-"
          f"{cfg.moe.top_k} + shared, vocab {cfg.vocab_size}, MTP), 61 "
          f"layers cut to 2 (MLA + dense, MLA + MoE), bf16: {n_params} "
          f"parameters, {nbytes / 1e9:.3f} GB ({expert_bytes / 1e9:.3f} GB "
          f"of experts), built in {init_s:.1f} s, peak memory "
          f"{init_peak / 2**30:.2f} GiB while building")
    print(f"[{card}] 25 loss (B={ZOO_BATCH}, S={ZOO_SEQ}): ce {ce:.4f}, aux "
          f"{aux:.6f}, mtp {mtp:.4f}, total {loss.item():.4f}; the "
          f"forward dropped {dropped} of {picks} token-expert picks "
          f"({dropped / picks:.2%}) at capacity {cfg.moe.capacity_factor}; "
          f"forward {fwd_ms:.2f} ms (CUDA events): MoE dispatch + combine "
          f"{split['dispatch'] + split['combine']:.2f} ms (dispatch "
          f"{split['dispatch']:.2f}, combine {split['combine']:.2f}), expert "
          f"products {split['experts']:.2f} ms (the expert weights "
          f"{expert_bytes / 1e9:.3f} GB read at 3.35 TB/s: "
          f"{expert_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms), rest "
          f"{fwd_ms - sum(split.values()):.2f} ms; peak memory "
          f"{(loss_peak - nbytes) / 2**30:.2f} GiB above the weights; no "
          f"hand kernel")
    del loss, met, batch, toks
    torch.cuda.empty_cache()

    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with MoEProbe() as probe:
        ids, prefill_ms, steps, wall = timed_generate(model, params,
                                                      prompts, SERVE_GEN)
        dec_dropped, dec_picks = probe.dropped()
    require_no_hand_kernel("DeepSeek-V3's generate")
    require(dec_picks == (SERVE_PROMPT + SERVE_GEN - 1) * SERVE_BATCH
            * cfg.moe.top_k and dec_dropped == 0,
            f"decode dropped {dec_dropped} of {dec_picks} picks")
    loop = token_loop(model, params, prompts, SERVE_GEN)
    require(torch.equal(ids, loop), f"generate's ids differ from the token "
                                    f"loop's in {int((ids != loop).sum())} "
                                    f"places")
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)[0]["b0"]
    per_token = cache["c"].shape[-1] + cache["k_rope"].shape[-1]
    require(per_token == cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            and set(cache) == {"c", "k_rope", "slot_pos"},
            f"the MLA cache holds {per_token} values a token")
    # per-head K (qk_nope + rope) and V: what the latents stand in for
    expanded = cfg.num_heads * (cfg.mla.qk_nope_head_dim
                                + cfg.mla.qk_rope_head_dim
                                + cfg.mla.v_head_dim)
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    n_new = SERVE_BATCH * SERVE_GEN
    print(f"[{card}] 25 generate (batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}, greedy): ids the token loop's "
          f"bit for bit; decode dropped {dec_dropped} of {dec_picks} picks "
          f"(capacity {moe_capacity(1, cfg.moe)} at S = 1, the top-"
          f"{cfg.moe.top_k} distinct); the MLA cache "
          f"{per_token} values a token a layer against {expanded} for "
          f"expanded K / V ({expanded / per_token:.1f}x smaller); prefill "
          f"{prefill_ms:.2f} ms; decode a step (CUDA events, {len(steps)} "
          f"steps) mean {np.mean(steps):.3f} ms, min {min(steps):.3f}, max "
          f"{max(steps):.3f} beside the weight-read bound {bound_ms:.3f} ms "
          f"({step_bytes / 1e9:.3f} GB / 3.35 TB/s, all weights but the "
          f"embedding table and the MTP block), "
          f"{bound_ms / np.mean(steps):.1%} of it; {n_new} tokens in "
          f"{wall * 1e3:.1f} ms (host clock) = "
          f"{n_new / wall:.1f} tokens/s; peak memory "
          f"{(torch.cuda.max_memory_allocated() - nbytes) / 2**30:.2f} GiB "
          f"above the weights; the phase's peak {init_peak / 2**30:.2f} GiB,"
          f" while building")
    del model, params, cache
    torch.cuda.empty_cache()


def phase_ssm_hybrid(card, qwen_step_ms):
    """26: mamba2-780m and recurrentgemma-9b at full size, f32: decode
    against forward, Mamba-2's ``generate`` against the token loop and its
    constant-size cache, RecurrentGemma's flash forward (hd 256, one KV
    head) against the xla path.  Returns the flash launches of that
    forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.transformer import Model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)

    cfg = get_config("mamba2-780m")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params, nbytes = model.param_count(params), weights_bytes(params)
    require(n_params == MAMBA_PARAMS, f"mamba2-780m has {n_params} "
                                      f"parameters, JAX's {MAMBA_PARAMS}")
    toks = torch.randint(0, cfg.vocab_size, (2, MAMBA_DECODE_SEQ),
                         generator=gen, device=dev)
    reset_launches()
    rel, steps, _ = decode_vs_forward(model, params, toks)
    require(rel < DECODE_TOL, f"mamba2-780m decode vs forward {rel:.3e}")
    prompts = toks[:, :MAMBA_PROMPT]
    ids, _, gen_steps, wall = timed_generate(model, params, prompts,
                                             MAMBA_GEN)
    require(torch.equal(ids, token_loop(model, params, prompts, MAMBA_GEN)),
            "mamba2-780m: generate's ids differ from the token loop's")
    small, large = (model.init_cache(2, n) for n in (32, 4096))
    from repro_torch.core.tree import tree_leaves
    require(all(a.shape == b.shape for a, b in zip(tree_leaves(small),
                                                   tree_leaves(large))),
            "the SSD cache grows with the context")
    cache_bytes = weights_bytes(small)
    del small, large
    long_toks = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                              device=dev)
    with torch.no_grad():
        model.forward(params, long_toks)
        fwd_ms = cuda_ms(lambda: model.forward(params, long_toks), reps=3,
                         warmup=0)
    # the decode check's forward and decode steps, the long forward's four
    # (generate's and the token loop's steps of two rows: none)
    require_no_hand_kernel("mamba2-780m", weight_products(cfg, *toks.shape)
                           + 4 * weight_products(cfg, *long_toks.shape)
                           + toks.shape[1] * weight_products(
                               cfg, 2, 1, cache=toks.shape[1]))
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[{card}] 26 mamba2-780m full ({cfg.num_layers} SSD layers, "
          f"d_model {cfg.d_model}, f32): {n_params} parameters, "
          f"{nbytes / 1e9:.3f} GB; decode vs "
          f"forward (B=2, S={MAMBA_DECODE_SEQ}, two chunks of "
          f"{cfg.ssm.chunk}) {rel:.3e} (tolerance {DECODE_TOL:g}); "
          f"generate (batch 2, prompt {MAMBA_PROMPT}, gen {MAMBA_GEN}) ids "
          f"the token loop's; the cache {cache_bytes / 2**20:.2f} MiB at "
          f"length 32 and at 4096; decode a step (CUDA events, "
          f"{len(steps)} steps at batch 2) mean {np.mean(steps):.3f} ms, "
          f"min {min(steps):.3f} (generate's {np.mean(gen_steps):.3f}) "
          f"beside the weight-read bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.3f} GB / 3.35 TB/s) and Qwen3-0.6B's "
          f"{qwen_step_ms:.3f} ms (phase 22, batch 4); a 2 x 2048 forward "
          f"{fwd_ms:.2f} ms (CUDA events, mean of 3); no hand kernel; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params, toks, long_toks
    torch.cuda.empty_cache()

    cfg = get_config("recurrentgemma-9b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params, nbytes = model.param_count(params), weights_bytes(params)
    require(n_params == RGEMMA_PARAMS, f"recurrentgemma-9b has {n_params} "
                                       f"parameters, JAX's {RGEMMA_PARAMS}")
    toks = torch.randint(0, cfg.vocab_size, (2, RGEMMA_DECODE_SEQ),
                         generator=gen, device=dev)
    reset_launches()
    rel, steps, _ = decode_vs_forward(model, params, toks)
    require_no_hand_kernel("recurrentgemma-9b's decode",
                           weight_products(cfg, *toks.shape)
                           + toks.shape[1] * weight_products(
                               cfg, 2, 1, cache=toks.shape[1]))
    require(rel < DECODE_TOL, f"recurrentgemma-9b decode vs forward "
                              f"{rel:.3e}")
    attn = [b for b in cfg.all_blocks() if b.mixer == "attn"]
    n_attn = len(attn)
    shapes = []
    kernel = flash_ops.flash_attention_bhsd

    def recording(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape), kw.get("window")))
        return kernel(q, k, v, **kw)

    flash_ops.flash_attention_bhsd = recording
    try:
        tokens = torch.randint(0, cfg.vocab_size, (1, RGEMMA_PREFILL + 1),
                               generator=gen, device=dev)
        launches = check_prefill(card, "RecurrentGemma-9B", cfg, params,
                                 tokens, n_attn)
    finally:
        flash_ops.flash_attention_bhsd = kernel
    # the KV head repeated for each query head, hd as the config has it
    bhsd = (cfg.num_heads, RGEMMA_PREFILL, cfg.resolved_head_dim)
    want = (bhsd, bhsd, attn[0].window)
    require(launches == n_attn and set(shapes) == {want},
            f"RecurrentGemma's flash calls: {launches} for {n_attn} "
            f"attention layers, shapes {sorted(set(shapes))}")
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[{card}] 26 recurrentgemma-9b full ({cfg.num_layers} layers: "
          f"(rglru, rglru, local attn) x 12 + (rglru, rglru), d_model "
          f"{cfg.d_model}, f32): {n_params} parameters, "
          f"{nbytes / 1e9:.3f} GB; decode vs forward (B=2, "
          f"S={RGEMMA_DECODE_SEQ}) {rel:.3e} (tolerance {DECODE_TOL:g}), no "
          f"hand kernel; decode a step (CUDA events, {len(steps)} steps at "
          f"batch 2) mean {np.mean(steps):.3f} ms, min {min(steps):.3f} "
          f"beside the weight-read bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.3f} GB / 3.35 TB/s); the flash forward's "
          f"{launches} launches, one per local-attention layer, at (BH, S, "
          f"hd) = {bhsd} ({cfg.num_heads} query heads on "
          f"{cfg.num_kv_heads} KV head, window {want[2]}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params, toks, tokens
    torch.cuda.empty_cache()
    return launches


def vmapped_grad_gap(model, params, stream) -> float:
    """max |d| / max |grad| over the tree (and the losses' relative gap)
    between ``lm_grad_fn``'s vmapped call for 2 workers (``params`` and
    1.01 x ``params``) and two separate ``grad_and_value`` calls on the
    same batches."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.transformer import lm_grad_fn
    dev = next(iter(tree_leaves(params))).device
    xs = tree_map(lambda a: torch.stack([a, 1.01 * a]), params)
    v_loss, v_grads = lm_grad_fn(model, stream)(
        xs, torch.Generator(device=dev).manual_seed(3),
        torch.arange(2, device=dev))
    b = stream.sample_workers(torch.Generator(device=dev).manual_seed(3), 2)
    worst = 0.0
    for w in range(2):
        g, loss = torch.func.grad_and_value(
            lambda p: model.loss(p, {"inputs": b["inputs"][w],
                                     "labels": b["labels"][w]})[0]
        )(tree_map(lambda a: a[w], xs))
        top = max(a.abs().max().item() for a in tree_leaves(g))
        diff = max((a[w] - c).abs().max().item() for a, c in
                   zip(tree_leaves(v_grads), tree_leaves(g)))
        worst = max(worst, diff / top,
                    abs(v_loss[w].item() - loss.item()) / abs(loss.item()))
    return worst


def phase_zoo_reduced(card):
    """27: the four families reduced, f32: decode against forward (MoE
    capacity 8), RecurrentGemma's ``windowed(8)`` rings, 8 SGD steps
    lowering the loss, ``lm_grad_fn``'s vmapped gradients against
    separate calls, and a 2-round ``run_sim`` on DeepSeek-V3.  Returns the
    clean kernel's and the tick tail's launches of that replay."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import (build_graph, coalesce_schedule,
                                  coalesced_stream, make_schedule)
    from repro_torch.core.tree import tree_map
    from repro_torch.data import LMTaskStream
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    products = 0
    for arch in ZOO_ARCHS:
        cfg = get_config(arch, reduced=True)
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        s = cfg.ssm.chunk if cfg.ssm else 32
        toks = torch.randint(0, cfg.vocab_size, (2, s + 1), generator=gen,
                             device=dev)
        uncapped = cfg if cfg.moe is None else cfg.with_updates(
            moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        rel, _, _ = decode_vs_forward(Model(uncapped), params, toks[:, :-1])
        require(rel < DECODE_TOL, f"{arch} decode vs forward {rel:.3e}")
        # each forward below (this check's and its s decode steps on
        # caches of s, the rings' the same, the SGD steps' and the f32
        # gradients': lm_grad_fn's and two separate calls) on (2, s)
        products += (1 + (cfg.rglru is not None)) * (
            weight_products(cfg, 2, s) + s * weight_products(
                cfg, 2, 1, cache=s)) + 3 * (ZOO_TRAIN_STEPS + 3) \
            * weight_products(cfg, 2, s, loss=True)
        notes = [f"decode vs forward {rel:.3e}"]
        if cfg.rglru is not None:
            ring = cfg.windowed(8)
            rel_w, _, caches = decode_vs_forward(Model(ring), params,
                                                 toks[:, :-1])
            k = caches[0]["b2"]["k"]
            require(rel_w < DECODE_TOL and k.shape[2] == 8,
                    f"{arch} windowed(8): {rel_w:.3e}, ring {k.shape}")
            notes.append(f"windowed(8) rings {rel_w:.3e}")
        step, opt = make_train_step(model, sgd(momentum=0.0), lr=ZOO_LR,
                                    remat=False)
        p0 = tree_map(torch.clone, params)
        state = TrainState(p0, opt.init(p0))
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        losses = []
        for _ in range(ZOO_TRAIN_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        require(np.isfinite(losses).all() and losses[-1] < losses[0],
                f"{arch}: {ZOO_TRAIN_STEPS} SGD steps {losses}")
        notes.append(f"{ZOO_TRAIN_STEPS} SGD steps (lr {ZOO_LR}) loss "
                     f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        del state, p0
        stream = LMTaskStream(vocab_size=cfg.vocab_size, seq_len=s,
                              batch_size=2, seed=SEED)
        gaps = []
        for dtype, tol in ZOO_GRAD_TOL.items():
            name = str(dtype)[6:]
            m = Model(cfg.with_updates(param_dtype=name, compute_dtype=name))
            gap = vmapped_grad_gap(m, tree_map(lambda a: a.to(dtype),
                                               params), stream)
            require(gap <= tol, f"{arch}: vmapped {name} gradients {gap:.3e}"
                                f" of the largest from separate calls, "
                                f"limit {tol:g}")
            gaps.append(f"{gap:.3e} in {name} (limit {tol:g})")
        notes.append("lm_grad_fn's vmapped gradients and losses for 2 "
                     "workers against separate calls, max|d| / max|grad|: "
                     + ", ".join(gaps))
        print(f"[{card}] 27 {arch} reduced ({model.param_count(params)} "
              f"parameters, f32): " + "; ".join(notes))
        del model, params
    require_no_hand_kernel("the reduced families", products)
    args = train.build_parser().parse_args(
        ["--arch", "deepseek-v3-671b", "--workers", "4", "--steps", "2",
         "--seq-len", "32", "--batch-size", "2", "--acid", "--no-bayes-ce"])
    sched = make_schedule(build_graph(args.graph, args.workers), rounds=2,
                          comms_per_grad=args.comms_per_grad,
                          seed=args.seed)
    comm_steps = int((~coalesced_stream(
        coalesce_schedule(sched), np.zeros(args.workers, np.float32)
    ).is_grad).sum())
    reset_launches()
    run = train.run_sim(args)
    launches = read_launches()
    products = weight_products(run.model.cfg, args.batch_size, args.seq_len,
                               loss=True)
    require_products(launches, stream_ticks(sched) * 3 * products,
                     "run_sim on reduced DeepSeek-V3")
    require(bool(torch.isfinite(run.trace.loss).all())
            and run.trace.loss.shape == (2,),
            f"run_sim on reduced DeepSeek-V3: losses {run.trace.loss}")
    require(launches["mixing_gossip_stacked"] == comm_steps
            and launches["tick_tail_stacked"] == stream_ticks(sched)
            and only_launched(launches, *CLEAN_REPLAY, DENSE),
            f"run_sim launched {launches}, {comm_steps} comm steps, "
            f"{stream_ticks(sched)} gradient ticks")
    print(f"[{card}] 27 run_sim reduced DeepSeek-V3 (4 workers, ring, "
          f"A2CiD2, 2 rounds): losses {run.trace.loss.tolist()}; "
          f"mixing_gossip_stacked launches "
          f"{launches['mixing_gossip_stacked']} == {comm_steps} comm "
          f"steps, tick_tail_stacked {launches['tick_tail_stacked']} == "
          f"{stream_ticks(sched)} gradient ticks, gemm_3xtf32 "
          f"{launches[DENSE]} == {stream_ticks(sched)} x 3 x {products} "
          f"weight products, every other kernel 0; the "
          f"phase's peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {name: launches[name] for name in CLEAN_REPLAY}


def phase_zoo(card, qwen_step_ms: float) -> dict:
    """25-27, each from an emptied cache (each prints its peak memory),
    timed; returns the hand-kernel launches of their main paths."""
    launches = {}
    for n, phase, args in ((25, phase_deepseek, ()),
                           (26, phase_ssm_hybrid, (qwen_step_ms,)),
                           (27, phase_zoo_reduced, ())):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = phase(card, *args)
        if n == 26:
            launches["flash_attention_bhsd"] = out
        elif n == 27:
            launches.update(out)
        print(f"[{card}] phase {n}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- 28: the sharded replay
# local shards on the one card; the lags held against shard_lag_schedule
SHARDS, SHARD_LAGS = 4, (1, 2)
# (c): every shard count down to one worker a shard, at a small and an odd
# (padded) width, both dtypes
EDGE_SHARDS, EDGE_WIDTHS, EDGE_ROUNDS = (1, 2, 4, 8, 16), (4224, 1001), 4
# (d): the paper's scale, 64 workers on a ring
PAPER_WORKERS, PAPER_SHARDS, PAPER_ROUNDS = 64, 8, 2
# comm-step times: runs of each arm in alternating order, the median kept
SHARD_TIMING_ORDER = ("sharded", "single", "single", "sharded", "sharded",
                      "single")
# (e): ResNet-18 on 4 shards against the default single-device replay, as a
# share of max|x|.  A vmap over 4 rows and one over 16 part by ~1.6e-6 of
# the largest gradient a tick and 6 rounds carry that to 4.09e-05 (on an
# H100 80GB HBM3 at 700 W); the limit leaves 2.4x of that, a sound control
# (gradients in 8-row groups) must stay under it, and a fault control (the
# cross-shard reads two rounds stale, lag 2) must break it
RESNET_SHARD_GAP = 1e-4
# traces are sums of per-shard partials (reassociated, never fed back):
# the JAX package's sharded pin holds them at rtol 1e-6; the telemetry
# moments at the engine tolerance
SHARD_TRACE_RTOL = 1e-6
# at bf16 the traces are rounded to bf16 after the sum: two roundings
SHARD_TRACE_RTOL_BF16 = 2.0 ** -6


def noisy_quadratic(n: int, d: int, seed: int):
    """A row-local noisy quadratic split into its draw and its use
    (``SplitGradFn``): worker w pulls toward ``amp[w] * base`` (base ~
    0.01 N(0, 1) over d, amp in [0.5, 1.5)), and the gradient carries 0.05
    N(0, 1) noise drawn for the whole world from the world's generator.
    Optima at 0.01 keep honest delta norms under tau (phase 6)."""
    from repro_torch.core import SplitGradFn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = 0.01 * torch.randn(d, generator=gen, device=dev)
    amp = 0.5 + torch.rand(n, generator=gen, device=dev)

    def draw(generator, rows):
        return torch.randn(rows, d, generator=generator, device=dev)

    def apply(x, noise, ids):
        g = (x - (amp[ids][:, None] * base).to(x.dtype)) \
            + (0.05 * noise).to(x.dtype)
        return 0.5 * (g.float() ** 2).sum(dim=1), g

    return SplitGradFn(draw, apply)


def quadratic_states(sim, b: int, n: int, d: int, seed: int,
                     dtype=torch.float32):
    """B worlds of n workers at 0, world w's generator seeded seed + w."""
    dev = torch.device("cuda")
    return sim.batch_states(
        sim.init(torch.zeros(d, dtype=dtype, device=dev), n,
                 torch.Generator(device=dev).manual_seed(seed + w))
        for w in range(b))


def shard_kernel_checks(card, graph, d: int) -> float:
    """``channel_gossip_worlds`` against its plain version at every shard
    shape phase 28 launches it at: (4, 4, d) on the main path, (1, 4, d)
    in the lags, (1, 8, d) for 64 workers on 8 shards, f32; and (4, Ws,
    width) for every edge shard count and width, f32 and bf16.  Returns
    the max abs err at f32."""
    from repro_torch.core import params_from_graph
    dev = torch.device("cuda")
    dyn_p = params_from_graph(graph, True)
    pw = worlds_dyn(dict(eta=dyn_p.eta, alpha=dyn_p.alpha,
                         alpha_t=dyn_p.alpha_tilde), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    full = {shape: check_shard_kernel(pw, *shape, d, d, torch.float32,
                                      F32_TOL, gen)
            for shape in ((N_WORLDS, N_WORKERS // SHARDS),
                          (1, N_WORKERS // SHARDS),
                          (1, PAPER_WORKERS // PAPER_SHARDS))}
    torch.cuda.empty_cache()
    edge = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for width in EDGE_WIDTHS:
        padded = -(-width // 128) * 128
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            for ns in EDGE_SHARDS:
                edge[dtype] = max(edge[dtype], check_shard_kernel(
                    pw, N_WORLDS, N_WORKERS // ns, padded, width, dtype, tol,
                    gen))
    print(f"[{card}] 28 channel_gossip_worlds vs plain on shard rows "
          f"(clip none / 2.5, with the mask): max abs err "
          + ", ".join(f"({b}, {ws}, {d}) {e:.3e}" for (b, ws), e in
                      full.items())
          + f" f32 (tolerance {F32_TOL:g}); (4, Ws, D) for Ws = "
          f"{[N_WORKERS // ns for ns in EDGE_SHARDS]}, D = {EDGE_WIDTHS} "
          f"(padded to 128): f32 {edge[torch.float32]:.3e}, bf16 "
          f"{edge[torch.bfloat16]:.3e} (tolerance {BF16_TOL:g}); masks "
          f"exactly mscale == 0, padding 0")
    return max(max(full.values()), edge[torch.float32])


def check_shard_kernel(pw, b: int, ws: int, d: int, d_real: int, dtype,
                       tol: float, gen) -> float:
    """``channel_gossip_worlds`` against its plain version on one shard's
    (b, ws, d) rows, the shape the sharded replay launches it at: honest,
    1e3-scale and sign-flip reads, rejected and norm-clipped rows, clip
    none and 2.5, with the rejection mask (exactly mscale == 0) and the
    padding columns left 0.  Returns the max abs err."""
    from repro_torch.kernels.a2cid2_mixing import kernel as k
    from repro_torch.kernels.a2cid2_mixing.ops import channel_event_worlds
    dev = torch.device("cuda")
    x, xt, xp = (torch.randn(b, ws, d, generator=gen, device=dev).to(dtype)
                 for _ in range(3))
    for a in (x, xt, xp):
        a[:, :, d_real:] = 0
    dt = torch.rand(b, ws, generator=gen, device=dev) * 1.5
    corrupt = torch.zeros(b, ws, device=dev)
    mscale = torch.ones(b, ws, device=dev)
    for w in range(b):
        corrupt[w, w % ws] = 999.0 if w % 2 else -2.0
        mscale[w, (w + 1) % ws] = 0.0 if w % 2 else 0.3
    pwb = tuple(p[N_WORLDS - b:].contiguous() for p in pw)   # A2CiD2 last
    err = 0.0
    for clip in (None, 2.5):
        kw = dict(clip=clip, want_rej=True)
        ref = channel_event_worlds(x, xt, xp, corrupt, mscale, dt, *pwb,
                                   backend="ref", **kw)
        out = k.channel_gossip_worlds(x, xt.clone(), xp, corrupt, mscale,
                                      dt, *pwb, **kw)
        torch.cuda.synchronize()
        for a, r in zip(out[:2], ref[:2]):
            err = max(err, (a.float() - r.float()).abs().max().item())
        require(torch.equal(out[2], ref[2])
                and torch.equal(out[2], (mscale == 0).float()),
                f"shard ({b}, {ws}, {d}) {dtype}: the rejection mask is not "
                f"exactly mscale == 0")
        require(bool((out[0][:, :, d_real:] == 0).all()
                     and (out[1][:, :, d_real:] == 0).all()),
                f"shard ({b}, {ws}, {d}) {dtype}: padding columns not 0")
    require(err <= tol, f"channel_gossip_worlds on shard rows ({b}, {ws}, "
                        f"{d}) {dtype}: max abs err {err} (tolerance {tol})")
    return err


def require_pinned(ref, got, what: str, rtol: float = SHARD_TRACE_RTOL
                   ) -> float:
    """The sharded replay ``got`` against the single-device ``ref``: x,
    x~, the clocks and every generator bit for bit, the defense trace and
    the telemetry counts bit for bit, the loss / consensus / mean-norm
    traces within ``rtol`` and the telemetry moments within ENGINE_TOL.
    Returns the largest trace error."""
    (f0, t0), (f1, t1) = ref, got
    require(tree_equal(f0.x, f1.x) and tree_equal(f0.x_tilde, f1.x_tilde)
            and torch.equal(f0.t_last, f1.t_last),
            f"{what}: x / x~ not bit for bit the single-device replay")
    require(all(torch.equal(a.get_state(), c.get_state())
                for a, c in zip(f0.generator, f1.generator)),
            f"{what}: a generator did not end where the single-device "
            f"replay leaves it")
    if t0.defense is not None:
        require(all(torch.equal(a, c) for a, c in zip(t0.defense,
                                                        t1.defense)),
                f"{what}: the defense trace differs")
    if t0.telemetry is not None:
        require(torch.equal(t0.telemetry.applied, t1.telemetry.applied)
                and torch.equal(t0.telemetry.rejected, t1.telemetry.rejected),
                f"{what}: telemetry counts differ")
        for k in ("norm_sum", "norm_sq_sum"):
            torch.testing.assert_close(getattr(t1.telemetry, k),
                                       getattr(t0.telemetry, k),
                                       rtol=ENGINE_TOL, atol=0)
    err = 0.0
    for k in ("loss", "consensus", "mean_param_norm"):
        a, c = getattr(t0, k), getattr(t1, k)
        err = max(err, ((a - c).abs() / a.abs().clamp_min(1e-30)).max()
                  .item())
    require(err <= rtol, f"{what}: traces differ by {err:.3e} (tolerance "
                         f"{rtol:g})")
    return err


class ShardTimer(ReplayTimer):
    """CUDA-event spans around the replay's comm-step parts and its ticks,
    patched in for one replay at a time."""

    PARTS = ("gather", "publish", "exchange", "merge", "norms", "kernel")

    def patched(self):
        import contextlib
        from repro_torch.core import FlatGossipEngine
        from repro_torch.core import engine as engine_mod
        from repro_torch.core import simulator as sim_mod
        from repro_torch.launch import mesh_replay
        targets = [
            (FlatGossipEngine, "partner_values_worlds", "gather", True),
            (FlatGossipEngine, "publish_rows", "publish", True),
            (FlatGossipEngine, "pool_partner_values", "merge", True),
            (FlatGossipEngine, "delta_norms", "norms", True),
            (mesh_replay, "ring_pool_exchange", "exchange", False),
            (engine_mod, "channel_event_worlds", "kernel", False),
            # the gradient tick: gradients, defense update, ring, mixing
            (sim_mod.Simulator, "_grad_worlds", "tick", False),
            (mesh_replay, "_grad_worlds_sharded", "tick", False),
            (sim_mod, "defense_grad", "tick", False),
            (mesh_replay, "defense_grad", "tick", False),
            (sim_mod, "ring_push_worlds", "tick", False),
            (mesh_replay, "ring_push_worlds", "tick", False),
            (FlatGossipEngine, "mix_batch", "tick", False),
        ]

        @contextlib.contextmanager
        def ctx():
            saved = [(obj, name, obj.__dict__[name])
                     for obj, name, _, _ in targets]
            try:
                for obj, name, kind, static in targets:
                    fn = getattr(obj, name)
                    wrapped = self.wrap(kind, fn)
                    setattr(obj, name, staticmethod(wrapped) if static
                            else wrapped)
                yield
            finally:
                for obj, name, fn in saved:
                    setattr(obj, name, fn)
        return ctx()

    def comm_split(self, arm: str, wall: float, comm_steps: int) -> dict:
        """Per comm step: each part's summed spans, and the rest (the
        replay's wall less its ticks and every part, over the comm
        steps)."""
        parts = {k: sum(self.ms(arm, k)) / comm_steps for k in self.PARTS
                 if self.ms(arm, k)}
        total = (wall - sum(self.ms(arm, "tick"))) / comm_steps
        parts["rest"] = total - sum(parts.values())
        parts["step"] = total
        return parts


def timed_replay(timer: ShardTimer, arm: str, run):
    """``run()`` under the timer's patches from an emptied peak: (final,
    trace, wall ms, peak GiB, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer.arm = arm
    reset_launches()
    with timer.patched():
        t0 = time.perf_counter()
        final, trace = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return (final, trace, wall, torch.cuda.max_memory_allocated() / 2**30,
            read_launches())


def phase_sharded(card, d: int, params0, cfg, stream_cls, grad_fn_for
                  ) -> int:
    """28: the sharded replay (``run_worlds(mesh=)``) on local shards of
    the one card, bit for bit the single-device replay: (a) phase 9's
    worlds on the noisy quadratic at full width, NS = 4 (the main path:
    its launches are counted), then lags 1 and 2 against
    ``shard_lag_schedule``; (b) ``channel_gossip_worlds`` once a comm step
    a shard and nothing else; (c) every shard count at small and odd
    widths, f32 and bf16, channel and defense, and the ragged fallback;
    (d) 64 workers on 8 shards; (e) ResNet-18-CIFAR, bit for bit the
    single-device replay with the shards' gradient groups and within
    ``RESNET_SHARD_GAP`` of the default single-device replay; (f) one NCCL
    rank.  The kernel is first held against its plain version at every
    shard shape.  Returns the main path's ``channel_gossip_worlds``
    launches and the kernel's max abs err at f32."""
    import warnings
    from repro_torch.core import (Simulator, Telemetry, World,
                                  params_from_graph, ring_graph,
                                  shard_lag_schedule)
    from repro_torch.launch import MeshReplay, make_replay_mesh
    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    def mesh(ns, lag=0):
        return MeshReplay(make_replay_mesh(ns, devices=[dev] * ns), lag=lag)

    # (a) + (b): phase 9's worlds, full width, with the flight recorder
    graph = ring_graph(N_WORKERS)
    worlds, defenses, scheds = hostile_worlds(graph)
    comm_steps = worlds_comm_steps(scheds)
    sim = Simulator(noisy_quadratic(N_WORKERS, d, SEED + 28),
                    params_from_graph(graph, True), GAMMA)

    def replay(ns=None):
        states = quadratic_states(sim, N_WORLDS, N_WORKERS, d, SEED + 28)
        return lambda: sim.run_worlds(
            states, scheds, worlds=worlds,
            robust_clips=[ROBUST_CLIP] * N_WORLDS, defenses=defenses,
            telemetry=Telemetry(), mesh=None if ns is None else mesh(ns))

    kerr = shard_kernel_checks(card, graph, d)
    timer = ShardTimer()
    f0, t0, _, _, _ = timed_replay(timer, "single", replay())
    f1, t1, _, _, launched = timed_replay(timer, "sharded", replay(SHARDS))
    err = require_pinned((f0, t0), (f1, t1), "28a phase 9's worlds")
    require(launched["channel_gossip_worlds"] == comm_steps * SHARDS,
            f"28b: channel_gossip_worlds launched "
            f"{launched['channel_gossip_worlds']} times, expected "
            f"{comm_steps} comm steps x {SHARDS} shards")
    require(only_launched(launched, "channel_gossip_worlds"),
            f"28b: another kernel launched on the sharded path: {launched}")
    require(bool(t1.telemetry.cross_reads.sum() > 0),
            "28a: no read crossed a shard boundary")
    dtr = t1.defense
    acted = float(dtr.rejections[2:].sum() + dtr.quarantined[2:].sum())
    require(acted >= 1, "28a: the defense arms rejected nothing")
    print(f"[{card}] 28a sharded replay, phase 9's worlds (B={N_WORLDS} x "
          f"{N_WORKERS} workers, noisy quadratic at D = {d}, "
          f"{CHANNEL_ROUNDS} rounds, static trim + defense, Telemetry()) "
          f"on {SHARDS} local shards of the card: x, x~, clocks, generators, "
          f"defense trace and telemetry counts bit for bit the "
          f"single-device replay; traces max rel err {err:.3e} "
          f"(tolerance {SHARD_TRACE_RTOL:g}); {int(t1.telemetry.cross_reads.sum())} "
          f"cross-shard reads, {int(t1.telemetry.bytes_cross.sum())} bytes "
          f"across, {int(t1.telemetry.bytes_intra.sum())} within; defense "
          f"acts {acted:.0f}")
    print(f"[{card}] 28b channel_gossip_worlds launches "
          f"{launched['channel_gossip_worlds']} == {comm_steps} comm steps "
          f"x {SHARDS} shards, other kernels 0")
    del f0, f1, t0, t1
    # both arms warmed up by the pinned runs above; then alternating runs
    splits = {"single": [], "sharded": []}
    peaks = {"single": 0.0, "sharded": 0.0}
    for i, arm in enumerate(SHARD_TIMING_ORDER):
        label = f"{arm} {i}"
        _, _, wall, peak, _ = timed_replay(
            timer, label, replay(SHARDS if arm == "sharded" else None))
        split = timer.comm_split(label, wall, comm_steps)
        split["tick"] = sum(timer.ms(label, "tick")) / CHANNEL_ROUNDS
        splits[arm].append(split)
        peaks[arm] = max(peaks[arm], peak)
    for arm, runs in splits.items():
        med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        desc = ", ".join(f"{k} {v:.4f}" for k, v in med.items()
                         if k not in ("step", "tick"))
        print(f"[{card}] 28 {arm} replay, median of {len(runs)} runs "
              f"(order {'/'.join(SHARD_TIMING_ORDER)}, after a warm-up of "
              f"each): per comm step {med['step']:.4f} ms = {desc} (ms, "
              f"CUDA events; rest = host clock less the spans); each run's "
              f"step {[round(r['step'], 4) for r in runs]}; ticks "
              f"{med['tick']:.2f} ms a round; peak memory {peaks[arm]:.2f} "
              f"GiB")
    torch.cuda.empty_cache()
    shard_norms(card, d)

    # (a) lags 1 and 2 on a clean ring world (B = 1), full width
    clean = [World(topology=graph).compile(CHANNEL_ROUNDS, seed=SEED)]
    for lag in SHARD_LAGS:
        ref = sim.run_worlds(quadratic_states(sim, 1, N_WORKERS, d, SEED),
                             [shard_lag_schedule(clean[0], SHARDS, lag)])
        got = sim.run_worlds(quadratic_states(sim, 1, N_WORKERS, d, SEED),
                             clean, mesh=mesh(SHARDS, lag))
        err = require_pinned(ref, got, f"28a lag {lag}")
        print(f"[{card}] 28a lag {lag} ({SHARDS} shards, clean ring, "
              f"D = {d}): bit for bit the single-device replay of "
              f"shard_lag_schedule(sched, {SHARDS}, {lag}); traces max rel "
              f"err {err:.3e}")
        del ref, got

    # (c) every shard count at small and odd widths, both dtypes
    t_edge, cases = time.perf_counter(), 0
    for width in EDGE_WIDTHS:
        qsim = Simulator(noisy_quadratic(N_WORKERS, width, SEED + 29),
                         params_from_graph(graph, True), GAMMA)
        for dtype in (torch.float32, torch.bfloat16):
            for flavour, dfs in (("channel", None), ("defense", defenses)):
                def run(ns):
                    return qsim.run_worlds(
                        quadratic_states(qsim, N_WORLDS, N_WORKERS, width,
                                         SEED + 29, dtype), scheds,
                        worlds=worlds, defenses=dfs,
                        robust_clips=[ROBUST_CLIP] * N_WORLDS,
                        mesh=None if ns is None else mesh(ns))
                ref = run(None)
                rtol = SHARD_TRACE_RTOL if dtype == torch.float32 \
                    else SHARD_TRACE_RTOL_BF16
                for ns in EDGE_SHARDS:
                    require_pinned(ref, run(ns), f"28c D={width} {dtype} "
                                   f"{flavour} NS={ns}", rtol)
                    cases += 1
        n_odd = N_WORKERS - 1
        osim = Simulator(noisy_quadratic(n_odd, width, SEED + 30),
                         params_from_graph(ring_graph(n_odd), True), GAMMA)
        osched = [World(topology=ring_graph(n_odd)).compile(EDGE_ROUNDS)]
        ref = osim.run_worlds(quadratic_states(osim, 1, n_odd, width, SEED),
                              osched)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = osim.run_worlds(quadratic_states(osim, 1, n_odd, width,
                                                   SEED), osched, mesh=mesh(2))
        require(any(issubclass(w.category, RuntimeWarning)
                    and "not divisible" in str(w.message) for w in caught),
                "28c: a ragged worker axis did not warn")
        require_pinned(ref, got, f"28c ragged n={n_odd} D={width}")
    print(f"[{card}] 28c {cases} sharded replays bit for bit single-device: "
          f"D = {EDGE_WIDTHS} (1001 padded to 1024), f32 and bf16, channel "
          f"and defense flavours, NS = {EDGE_SHARDS} (down to 1 worker a "
          f"shard); n = 15 on 2 shards warned 'not divisible' and replayed "
          f"on one device bit for bit; {time.perf_counter() - t_edge:.1f} s")

    # (d) the paper's scale: 64 workers on a ring, 8 shards, full width
    big = ring_graph(PAPER_WORKERS)
    bsim = Simulator(noisy_quadratic(PAPER_WORKERS, d, SEED + 31),
                     params_from_graph(big, True), GAMMA)
    bsched = [World(topology=big).compile(PAPER_ROUNDS, seed=SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_big = time.perf_counter()
    ref = bsim.run_worlds(quadratic_states(bsim, 1, PAPER_WORKERS, d, SEED),
                          bsched)
    got = bsim.run_worlds(quadratic_states(bsim, 1, PAPER_WORKERS, d, SEED),
                          bsched, mesh=mesh(PAPER_SHARDS))
    torch.cuda.synchronize()
    err = require_pinned(ref, got, "28d 64 workers")
    print(f"[{card}] 28d {PAPER_WORKERS} workers on a ring, "
          f"{PAPER_SHARDS} shards, D = {d} ({PAPER_WORKERS * d * 4:,} bytes "
          f"a bank), {PAPER_ROUNDS} rounds: bit for bit the single-device "
          f"replay, traces max rel err {err:.3e}; both replays "
          f"{time.perf_counter() - t_big:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ref, got, bsim
    torch.cuda.empty_cache()

    # (e) ResNet-18-CIFAR, the whole model, through the draw / apply split
    t_res = time.perf_counter()
    res = sharded_resnet(card, mesh, grad_fn_for(cfg, stream_cls(
        batch_size=BATCH)), cfg, params0, worlds, defenses, scheds)
    err = require_pinned(res["grouped"], res["sharded"],
                         "28e ResNet-18 against the shards' gradient groups")
    require(bool(torch.isfinite(res["sharded"][1].loss).all()),
            "28e: non-finite loss")
    from repro_torch.core.tree import tree_leaves
    x_ref = tree_leaves(res["default"][0].x)
    big_x = max(a.abs().max().item() for a in x_ref)

    def gap(arm):
        return max((a - c).abs().max().item() for a, c in
                   zip(x_ref, tree_leaves(res[arm][0].x))) / big_x

    gaps = {arm: gap(arm) for arm in ("sharded", "groups of 8", "lag 2")}
    require(gaps["sharded"] <= RESNET_SHARD_GAP,
            f"28e: the sharded ResNet-18 replay is {gaps['sharded']:.3e} of "
            f"max|x| from the default single-device replay (limit "
            f"{RESNET_SHARD_GAP:g})")
    require(gaps["groups of 8"] <= RESNET_SHARD_GAP,
            f"28e: the sound control (8-row gradient groups) is "
            f"{gaps['groups of 8']:.3e} of max|x| from the default replay")
    require(gaps["lag 2"] > RESNET_SHARD_GAP,
            f"28e: the fault control (lag 2) is only {gaps['lag 2']:.3e} of "
            f"max|x| from the default replay: the limit cannot see a fault")
    print(f"[{card}] 28e ResNet-18-CIFAR, phase 9's worlds, {SHARDS} "
          f"shards: bit for bit the single-device replay whose gradient is "
          f"applied in the shards' {N_WORKERS // SHARDS}-row groups (traces "
          f"max rel err {err:.3e}); from the default single-device replay "
          f"(one vmapped gradient of 16 rows), max |dx| / max|x| "
          f"({big_x:.4f}): sharded {gaps['sharded']:.3e} (limit "
          f"{RESNET_SHARD_GAP:g}), sound control, gradients in 8-row groups, "
          f"{gaps['groups of 8']:.3e}, fault control, {SHARDS} shards at lag "
          f"2, {gaps['lag 2']:.3e}; loss "
          f"{res['sharded'][1].loss[:, -1].tolist()} against "
          f"{res['default'][1].loss[:, -1].tolist()}; five replays "
          f"{time.perf_counter() - t_res:.1f} s")
    del res
    torch.cuda.empty_cache()

    # (f) the rank path: one NCCL rank, every collective still called
    phase_rank(card, d, sim, worlds, defenses, scheds)
    print(f"[{card}] phase 28: {time.perf_counter() - t_phase:.1f} s")
    return launched["channel_gossip_worlds"], kerr


def shard_norms(card, d: int) -> None:
    """The delta norms three ways, each after the same element-wise part:
    the replay's (``FlatGossipEngine.delta_norms``, sums on blocks of
    ``NORM_GROUP`` rows), each row summed alone and one sum over all
    rows.  At D = 4224 and at
    ``d``: how many norms of a shard's (4, Ws, D) rows differ from the
    same rows' norms among 16 for Ws = 1, 2, 4, 8 (PyTorch picks a
    reduction's split from the row count as well as the length; the
    replay's may differ in none).  Each form, and the element-wise part
    alone, timed (CUDA events) at (4, 16, D), (4, 4, D) and (1, 64, D)."""
    from repro_torch.core import FlatGossipEngine
    from repro_torch.core.engine import NORM_GROUP, _delta_f32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)

    def blocks(a, b, c):
        return FlatGossipEngine.delta_norms(a, b, c, axes=2)

    def squares(a, b, c):   # delta_norms' element-wise part
        m = _delta_f32(a, (1.0 + c.float()).to(a.dtype).unsqueeze(-1) * b)
        return m * m

    def rows_alone(a, b, c):
        sq = squares(a, b, c).reshape(-1, a.shape[-1])
        return torch.sqrt(torch.stack([r.sum() for r in sq])
                          .reshape(a.shape[:-1]))

    def one_sum(a, b, c):
        return torch.sqrt(squares(a, b, c).sum(dim=2))

    forms = {f"blocks of {NORM_GROUP}": blocks, "each row alone": rows_alone,
             "one sum": one_sum, "the element-wise part alone": squares}
    for width in (EDGE_WIDTHS[0], d):
        bx = torch.randn(N_WORLDS, N_WORKERS, width, generator=gen,
                         device=dev)
        xp = torch.randn(N_WORLDS, N_WORKERS, width, generator=gen,
                         device=dev)
        cor = torch.zeros(N_WORLDS, N_WORKERS, device=dev)
        differ = {}
        for label, fn in list(forms.items())[:3]:
            whole = fn(bx, xp, cor)
            differ[label] = [int((fn(bx[:, :ws].contiguous(),
                                     xp[:, :ws].contiguous(),
                                     cor[:, :ws].contiguous())
                                  != whole[:, :ws]).sum())
                             for ws in (1, 2, 4, 8)]
        require(not any(differ[f"blocks of {NORM_GROUP}"]),
                f"28a: the replay's delta norms depend on the rows at "
                f"D = {width}")
        reps = 5 if width == d else 20
        times = []
        for shape in ((N_WORLDS, N_WORKERS), (N_WORLDS, N_WORKERS // SHARDS),
                      (1, PAPER_WORKERS)):
            # the first rows of the (4, 16) bank: 64 rows at most
            a, b = (t.reshape(-1, width)[:shape[0] * shape[1]]
                    .reshape(*shape, width) for t in (bx, xp))
            c = torch.zeros(shape, device=dev)
            times.append(f"{shape}: " + ", ".join(
                f"{label} {cuda_ms(lambda: fn(a, b, c), reps=reps):.4f}"
                for label, fn in forms.items()))
        print(f"[{card}] 28a delta norms at D = {width}: of a shard's "
              f"(4, Ws) norms for Ws = 1, 2, 4, 8, differing from the same "
              f"rows' norms among 16: "
              + ", ".join(f"{k} {v}" for k, v in differ.items())
              + f"; ms (CUDA events, mean of {reps}) at "
              + "; ".join(times))
        del bx, xp
        torch.cuda.empty_cache()


def sharded_resnet(card, mesh, gfn, cfg, params0, worlds, defenses,
                   scheds) -> dict:
    """28e: phase 9's worlds on the whole model five ways, keyed: the
    "default" single-device replay (``gfn`` vmapped over all 16 rows),
    the single-device replay whose gradient is applied in the shards' row
    groups ("grouped", one vmapped call a group, as each shard makes it),
    the "sharded" replay on ``mesh(SHARDS)``, and two controls: the
    single-device replay with gradients in "groups of 8" rows, and the
    sharded replay at "lag 2".  A vmap over 4 rows and one over 16 may sum
    in another order (cuDNN picks a grouped convolution's algorithm from
    the group count), so the sharded replay is held bit for bit against
    "grouped".  Before the replays, one tick's gradients from the start
    are timed and compared: vmapped over 16 rows in one call and in the
    shards' groups, and the same with ``vmap(chunk_size=1)``."""
    from torch.func import grad_and_value, vmap
    from repro_torch.core import Simulator, SplitGradFn, params_from_graph
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.resnet import resnet_loss

    def row_groups(ws):
        return [slice(u, u + ws) for u in range(0, N_WORKERS, ws)]

    def grouped(apply, groups):
        def run(x, batch, ids):
            outs = [apply(tree_map(lambda a: a[g], x),
                          tree_map(lambda a: a[g], batch), ids[g])
                    for g in groups]
            return (torch.cat([o[0] for o in outs]),
                    tree_map(lambda *gs: torch.cat(gs),
                             *[o[1] for o in outs]))
        return run

    def loss_one(p, images, labels):
        return resnet_loss(p, cfg, {"images": images, "labels": labels})[0]

    # one tick's gradients from the replay's start, two vmaps, two batchings
    dev = torch.device("cuda")
    x0 = tree_map(lambda a: a.unsqueeze(0).expand((N_WORKERS,) + a.shape)
                  .contiguous(), params0)
    batch = gfn.draw(torch.Generator(device=dev).manual_seed(SEED + 1),
                     N_WORKERS)
    ids = torch.arange(N_WORKERS, device=dev)
    shard_rows = row_groups(N_WORKERS // SHARDS)
    ref = tree_leaves(gfn.apply(x0, batch, ids)[1])
    big = max(a.abs().max().item() for a in ref)
    desc = []
    for name, chunk in (("vmap", None), ("vmap(chunk_size=1)", 1)):
        per_worker = vmap(grad_and_value(loss_one), chunk_size=chunk)

        def apply(x, b, _ids, f=per_worker):
            grads, losses = f(x, b["images"], b["labels"])
            return losses, grads

        got, ms = {}, {}
        for label, groups in (("16 rows", [slice(0, N_WORKERS)]),
                              (f"{len(shard_rows)} groups", shard_rows)):
            run = grouped(apply, groups)
            ms[label] = cuda_ms(lambda: run(x0, batch, ids), reps=1,
                                warmup=1)
            got[label] = tree_leaves(run(x0, batch, ids)[1])
        one, split = got.values()
        same = all(torch.equal(a, c) for a, c in zip(one, split))
        gap = max((a - c).abs().max().item() for a, c in zip(one, split))
        to_ref = max((a - c).abs().max().item() for a, c in zip(ref, one))
        desc.append(f"{name}: " + ", ".join(f"{k} {v:.1f} ms"
                                            for k, v in ms.items())
                    + f", the batchings {'bit for bit' if same else 'apart'}"
                      f" ({gap / big:.3e} of the largest), 16 rows "
                      f"{to_ref / big:.3e} from the replay's gradient")
        del got, one, split
    print(f"[{card}] 28e one tick's ResNet-18 gradients at the start (16 "
          f"workers, batch {BATCH}; CUDA events, one call after a warm-up): "
          + "; ".join(desc))
    del x0, batch, ref

    mk = {"default": (gfn, None),
          "grouped": (SplitGradFn(gfn.draw, grouped(gfn.apply, shard_rows)),
                      None),
          "sharded": (gfn, mesh(SHARDS)),
          "groups of 8": (SplitGradFn(gfn.draw, grouped(gfn.apply,
                                                        row_groups(8))),
                          None),
          "lag 2": (gfn, mesh(SHARDS, 2))}
    out = {}
    for arm, (fn, m) in mk.items():
        sim = Simulator(fn, params_from_graph(worlds[0].topology, True),
                        GAMMA)
        out[arm] = sim.run_worlds(
            worlds_states(sim, params0, SEED + 1), scheds, worlds=worlds,
            robust_clips=[ROBUST_CLIP] * N_WORLDS, defenses=defenses,
            mesh=m)
    torch.cuda.synchronize()
    return out


def phase_rank(card, d, sim, worlds, defenses, scheds) -> None:
    """28f: ``make_rank_mesh()`` under NCCL at world size 1 (NCCL takes
    one rank a card) on phase 9's worlds at full width, bit for bit the
    single-device replay."""
    import torch.distributed as dist
    from repro_torch.launch import MeshReplay, make_rank_mesh

    def run(mesh=None):
        return sim.run_worlds(
            quadratic_states(sim, N_WORLDS, N_WORKERS, d, SEED + 28),
            scheds, worlds=worlds, robust_clips=[ROBUST_CLIP] * N_WORLDS,
            defenses=defenses, mesh=mesh)

    ref = run()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            rank_mesh = make_rank_mesh()
            got = run(MeshReplay(rank_mesh))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    err = require_pinned(ref, got, "28f NCCL rank")
    print(f"[{card}] 28f rank mesh: NCCL, world size 1 on "
          f"{rank_mesh.device}, phase 9's worlds at D = {d}: bit for bit the "
          f"single-device replay, traces max rel err {err:.3e}")


# phase 29: the dry run on the meta device, three of its steps on the card

# (a) the combinations run here (the rest, the train steps at full size and
# the prefills, run through the CLI on a host:
# `python -m repro_torch.launch.dryrun --all --mesh single`, PERF.md): every
# architecture's two decode shapes, and two prefills at 32k
DRYRUN_ARCH_SHAPES = ("decode_32k", "long_500k")
DRYRUN_PREFILLS = (("qwen3-0.6b", "prefill_32k"),
                   ("deepseek-v3-671b", "prefill_32k"))
# (b) the steps run for real on a one-card mesh: (label, arch, config
# updates, shape); bf16 weights and compute, as the dry run takes them
CARD_STEPS = (
    ("Qwen3-0.6B prefill 2 x 4096, flash", "qwen3-0.6b",
     {"attention_impl": "pallas"}, ("prefill_4k", 4096, 2, "prefill")),
    ("Qwen3-0.6B decode_32k at batch 4", "qwen3-0.6b", {},
     ("decode_32k", 32768, 4, "decode")),
    ("nano-lm train 16 x 512, 4 micro-batches", "nano-lm", {},
     ("train_512", 512, 16, "train")),
)
# the card's peak allocation above its arguments over the meta trace's
# activation peak, predicted in PERF.md before the first run: the decode
# and train steps run the meta trace's aten ops (1.0 but for the
# allocator's 512-byte rounding); the prefill runs the flash kernel where
# the meta trace runs its plain version, whose f32 scores are not made
# (0.532 when the kernel's output alone is traced)
MEMORY_RATIO = {CARD_STEPS[0][0]: (0.50, 0.60),
                CARD_STEPS[1][0]: (0.95, 1.10),
                CARD_STEPS[2][0]: (0.95, 1.15)}
# (c) phase 9's worlds, cut to 2 rounds
EXEC_ROUNDS = 2


def dryrun_subset(card) -> None:
    """(a): the dry run's combinations on the single-pod mesh and its six
    gossip modes, on the meta device; each must pass."""
    import contextlib
    import io
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.launch import dryrun
    combos = [(a, s) for a in ARCHITECTURES for s in DRYRUN_ARCH_SHAPES] \
        + list(DRYRUN_PREFILLS)
    t0 = time.perf_counter()
    ok = 0
    for arch, shape in combos:
        with contextlib.redirect_stdout(io.StringIO()):
            out = dryrun.run_one(arch, shape, "single")
        require(out["ok"] and out["hlo_flops_per_device"] > 0,
                f"dry run {arch} x {shape} failed: {out}")
        ok += 1
        print(f"[{card}] dry run {arch} x {shape} x single: peak/device "
              f"{out['peak_memory_per_device'] / 1e9:.2f} GB (fits "
              f"{out['fits_h100_hbm']}), FLOPs/device "
              f"{out['hlo_flops_per_device']:.4e}, bytes/device "
              f"{out['hlo_bytes_per_device']:.4e}, collective/device "
              f"{out['collective_bytes_per_device']:.4e}, bottleneck "
              f"{out['bottleneck']}")
    for kw in dryrun.GOSSIP_RUNS:
        with contextlib.redirect_stdout(io.StringIO()):
            out = dryrun.run_gossip_step("qwen3-0.6b", **kw)
        require(out["ok"] and out["hlo_flops_per_device"] > 0,
                f"gossip dry run {kw} failed: {out}")
        ok += 1
        print(f"[{card}] dry run gossip {kw}: peak/device "
              f"{out['peak_memory_per_device'] / 1e9:.2f} GB, FLOPs/device "
              f"{out['hlo_flops_per_device']:.4e}, collective/device "
              f"{out['collective_bytes_per_device']:.4e}")
    n = len(combos) + len(dryrun.GOSSIP_RUNS)
    print(f"[{card}] dry run: {ok}/{n} combos OK in "
          f"{time.perf_counter() - t0:.1f} s (meta device, no card)")


def card_args(spec, cfg, shape, dev):
    """The step's arguments on the card, built as the port builds them
    (weights from seed 0, random tokens, empty caches)."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.models.transformer import Model
    from repro_torch.optim import sgd
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen)

    def tokens(like):
        return torch.randint(0, cfg.vocab_size, tuple(like.shape),
                             generator=gen, device=dev, dtype=torch.int32)

    if shape.kind == "train":
        return (TrainState(params, sgd().init(params)),
                {k: tokens(v) for k, v in spec.args[1].items()})
    if shape.kind == "prefill":
        return params, {"inputs": tokens(spec.args[1]["inputs"])}
    return (params, model.init_cache(shape.global_batch, shape.seq_len,
                                     device=dev),
            tokens(spec.args[2]),
            torch.tensor(shape.seq_len // 2, dtype=torch.int32, device=dev))


def card_step(card, label, arch, updates, shape_args) -> int:
    """(b) one step: its dry run on a one-card mesh, then the step on the
    card; returns the flash launches."""
    from repro_torch.analysis.op_cost import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import AbstractMesh, rules_for
    from repro_torch.launch.steps import bundle_for
    from repro_torch.shapes import InputShape
    mesh = AbstractMesh(("data", "model"), (1, 1))
    shape = InputShape(*shape_args)
    cfg = get_config(arch).with_updates(param_dtype="bfloat16",
                                        compute_dtype="bfloat16", **updates)
    spec = bundle_for(cfg, shape, mesh, rules_for(mesh))
    meta = spec.trace(mesh)
    arg_bytes = spec.arg_bytes(mesh)
    dev = resolve_device()
    args = card_args(spec, cfg, shape, dev)
    want = [t for t in tree_leaves(spec.args) if t is not None]
    got = [t for t in tree_leaves(args) if t is not None]
    require(len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want)),
        f"{label}: the card's arguments are not the dry run's")
    real_bytes = sum(t.numel() * t.element_size() for t in got)
    require(real_bytes == arg_bytes,
            f"{label}: {real_bytes} argument bytes on the card, the dry run "
            f"counts {arg_bytes}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    with OpCounter() as counter:
        out = spec.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = read_launches()
    cost = counter.cost()
    first = tree_leaves(out)[0]
    require(bool(torch.isfinite(first.float()).all()),
            f"{label}: non-finite output")
    del out
    flash = launches["flash_attention_bhsd"]
    rec = cost.recorded.get("flash_attention_bhsd", {}).get("calls", 0)
    if updates.get("attention_impl") == "pallas":
        require(flash == cfg.num_layers and rec == flash,
                f"{label}: flash launched {flash} times, reported {rec}; "
                f"{cfg.num_layers} attention layers")
    require(only_launched(launches, "flash_attention_bhsd"),
            f"{label}: another kernel launched: {launches}")
    require(cost.flops == meta.flops,
            f"{label}: {cost.flops:.6e} FLOPs counted on the card, "
            f"{meta.flops:.6e} on the meta device")
    ratio = peak / meta.peak_live_bytes
    lo, hi = MEMORY_RATIO[label]
    require(lo <= ratio <= hi,
            f"{label}: card peak {peak} over the meta trace's "
            f"{meta.peak_live_bytes:.0f} is {ratio:.4f}, outside the "
            f"predicted [{lo}, {hi}]")
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = spec.fn(*args)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
        del out
    ms = float(np.median(runs))
    meta_bound = max(meta.flops / PEAK_BF16_FLOPS,
                     meta.write_bytes / PEAK_BYTES_PER_S) * 1e3
    card_bound = max(cost.flops / PEAK_BF16_FLOPS,
                     cost.write_bytes / PEAK_BYTES_PER_S) * 1e3
    print(f"[{card}] {label}: arguments {arg_bytes} bytes = the dry run's; "
          f"FLOPs {cost.flops:.6e} on the card (flash reports "
          f"{cost.recorded.get('flash_attention_bhsd', {}).get('flops', 0):.4e}"
          f" in {rec} calls) == {meta.flops:.6e} on the meta device; peak "
          f"{peak / 2**30:.3f} GiB above the arguments, the meta trace's "
          f"{meta.peak_live_bytes / 2**30:.3f} GiB (ratio {ratio:.4f}, "
          f"predicted [{lo}, {hi}]); bytes written {cost.write_bytes:.4e} "
          f"on the card, {meta.write_bytes:.4e} on the meta device")
    print(f"[{card}] {label}: {ms:.3f} ms (median of 5, CUDA events; runs "
          f"{', '.join(f'{r:.3f}' for r in runs)}); roofline bound "
          f"{meta_bound:.3f} ms from the dry run ({100 * meta_bound / ms:.1f}"
          f"%), {card_bound:.3f} ms from the card's own count "
          f"({100 * card_bound / ms:.1f}%), bf16 at "
          f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s, {PEAK_BYTES_PER_S / 1e12:.2f}"
          f" TB/s")
    del args
    torch.cuda.empty_cache()
    return flash


def executable_vs_run_worlds(card, params0, cfg, stream_cls, grad_fn_for
                             ) -> int:
    """(c) phase 9's worlds: ``worlds_executable``'s ``fn(*args)`` bit for
    bit ``run_worlds``; returns the channel kernel's launches."""
    from repro_torch.core import Simulator, params_from_graph, ring_graph
    graph = ring_graph(N_WORKERS)
    worlds, defenses, _ = hostile_worlds(graph)
    scheds = [w.compile(EXEC_ROUNDS, seed=CHANNEL_SEED) for w in worlds]
    sim = Simulator(grad_fn_for(cfg, stream_cls(batch_size=BATCH)),
                    params_from_graph(graph, True), GAMMA)
    kw = dict(worlds=worlds, robust_clips=[ROBUST_CLIP] * N_WORLDS,
              defenses=defenses)
    reset_launches()
    want, wtr = sim.run_worlds(worlds_states(sim, params0, SEED + 1), scheds,
                               **kw)
    torch.cuda.synchronize()
    n_want = read_launches()
    fn, args = sim.worlds_executable(worlds_states(sim, params0, SEED + 1),
                                     scheds, **kw)
    reset_launches()
    got, gtr = fn(*args)
    torch.cuda.synchronize()
    n_got = read_launches()
    same = (tree_equal(want.x, got.x) and tree_equal(want.x_tilde, got.x_tilde)
            and torch.equal(want.t_last, got.t_last)
            and all(torch.equal(a.get_state(), b.get_state())
                    for a, b in zip(want.generator, got.generator))
            and all(torch.equal(getattr(wtr, k), getattr(gtr, k))
                    for k in ("loss", "consensus", "mean_param_norm"))
            and all(torch.equal(a, b) for a, b in zip(wtr.defense,
                                                      gtr.defense)))
    require(same, "worlds_executable's fn(*args) is not bit for bit "
                  "run_worlds on phase 9's worlds")
    require(n_got == n_want and n_got["channel_gossip_worlds"] > 0,
            f"worlds_executable launched {n_got}, run_worlds {n_want}")
    print(f"[{card}] worlds_executable on phase 9's worlds ({EXEC_ROUNDS} "
          f"rounds, B = {N_WORLDS}): fn = {fn.__name__}, fn(*args) bit for "
          f"bit run_worlds (x, x~, clocks, generators, trace, defense "
          f"trace); channel_gossip_worlds launched "
          f"{n_got['channel_gossip_worlds']} times each")
    return n_got["channel_gossip_worlds"]


def phase_dryrun(card, params0, cfg, stream_cls, grad_fn_for) -> dict:
    """Phase 29; returns the flash and channel worlds launches of its main
    paths."""
    t0 = time.perf_counter()
    dryrun_subset(card)
    flash = sum(card_step(card, *step) for step in CARD_STEPS)
    chan = executable_vs_run_worlds(card, params0, cfg, stream_cls,
                                    grad_fn_for)
    print(f"[{card}] phase 29: {time.perf_counter() - t0:.1f} s")
    return {"flash_attention_bhsd": flash, "channel_gossip_worlds": chan}


# ------------------------------------------- 30: RMSNorm VJP, the examples
RMS_VJP_SHAPES = ((8192, 1024), (4, 4096, 1024))
# card against the same function on CPU copies, max|d| / max|ref| of each
# output: f32 as phase 12's kernel; bf16 the JAX package's RMSNorm bf16
# tolerance
RMS_VJP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# forward + backward at (8192, 1024), ms (PERF.md section 6, NVIDIA H100
# 80GB HBM3 at 700 W): autograd through x * x summed, then through the
# einsum, and that autograd form timed in turns beside the custom VJP
EARLIER_RMS_FWD_BWD_MS = ("0.50-0.72 (autograd, x * x summed), 1.19-1.45 "
                          "(autograd, the einsum), the einsum's autograd "
                          "form in turns with the custom VJP: median "
                          "1.3398 f32, 1.5250 bf16")
RMS_VMAP_WORKERS = 8
RMS_TIMINGS = 6


def rms_inputs(shape, dtype, dev):
    gen = torch.Generator().manual_seed(24)
    x = 3 * torch.randn(shape, generator=gen)
    scale = 0.1 * torch.randn(shape[-1:], generator=gen)
    g = torch.randn(shape, generator=gen)
    return [t.to(dtype).to(dev) for t in (x, scale, g)]


def rms_fwd_bwd(fn, x, scale, g):
    xa, sa = x.detach().requires_grad_(), scale.detach().requires_grad_()
    out = fn(xa, sa)
    gx, gs = torch.autograd.grad(out, (xa, sa), g)
    return out.detach(), gx, gs


def phase_rmsnorm_vjp(card, dev=None) -> None:
    """30a: ``models.layers.rmsnorm``'s custom VJP on the card against the
    same function on CPU copies, its forward + backward time beside the
    earlier autograd form's recorded times, and a ``vmap`` of ``grad``
    over 8 workers."""
    from repro_torch.models.layers import rmsnorm
    dev = dev or torch.device("cuda")
    for shape in RMS_VJP_SHAPES:
        for dtype, tol in RMS_VJP_TOL.items():
            x, scale, g = rms_inputs(shape, dtype, dev)
            got = rms_fwd_bwd(rmsnorm, x, scale, g)
            want = rms_fwd_bwd(rmsnorm, x.cpu(), scale.cpu(), g.cpu())
            parts = []
            for name, a, b in zip(("out", "gx", "gscale"), got, want):
                require(a.dtype == b.dtype and a.shape == b.shape,
                        f"rmsnorm VJP {shape} {dtype} {name}: "
                        f"{a.dtype} {tuple(a.shape)}")
                a = a.cpu()
                err = float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                share = float((a == b).float().mean())
                require(err <= tol, f"rmsnorm VJP {shape} {dtype} {name}: "
                                    f"{err:.3e} > {tol}")
                parts.append(f"{name} {err:.3e} ({share:.4%} bitwise)")
            print(f"[{card}] phase 30a: rmsnorm VJP {tuple(shape)} {dtype} "
                  f"card vs CPU, max|d| / max|ref| (tol {tol}): "
                  f"{', '.join(parts)}")
            del x, scale, g, got, want
    for dtype in RMS_VJP_TOL:
        x, scale, g = rms_inputs(RMS_VJP_SHAPES[0], dtype, dev)
        t = [cuda_ms(lambda: rms_fwd_bwd(rmsnorm, x, scale, g), reps=50,
                     warmup=3) for _ in range(RMS_TIMINGS)]
        print(f"[{card}] phase 30a: rmsnorm forward + backward "
              f"{RMS_VJP_SHAPES[0]} {dtype}, each a mean of 50 (CUDA "
              f"events): median {np.median(t):.4f} "
              f"{[round(r, 4) for r in t]} ms; earlier records "
              f"{EARLIER_RMS_FWD_BWD_MS} ms")
    for dtype, tol in RMS_VJP_TOL.items():
        xs, _, gs = rms_inputs((RMS_VMAP_WORKERS, 2048, 1024), dtype, dev)
        ss = (0.1 * torch.randn((RMS_VMAP_WORKERS, 1024),
                                generator=torch.Generator().manual_seed(25))
              ).to(dtype).to(dev)

        def loss(a, s, c):
            return (rmsnorm(a, s) * c).sum()
        gx, gsc = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(
            xs, ss, gs)
        err = 0.0
        for w in range(RMS_VMAP_WORKERS):
            lx, ls = torch.func.grad(loss, argnums=(0, 1))(xs[w], ss[w],
                                                          gs[w])
            for a, b in ((gx[w], lx), (gsc[w], ls)):
                err = max(err, float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max()))
        require(bool(torch.isfinite(gx).all() and torch.isfinite(gsc).all())
                and err <= tol,
                f"rmsnorm vmap of grad {dtype}: {err:.3e} > {tol}")
        print(f"[{card}] phase 30a: vmap(grad) over {RMS_VMAP_WORKERS} "
              f"workers of (2048, 1024) {dtype} against single calls: "
              f"max|d| / max|ref| {err:.3e}")


def quickstart_paths(qs) -> dict:
    """Each quickstart section's kernel launches: once a comm step of each
    arm's compiled stream (the worlds kernel once a shared step of the
    sweep), and in the clean sections the tick tail once a gradient
    tick."""
    from repro_torch.core import AdaptiveDefense, World, ring_graph
    n, rounds = qs.N_WORKERS, qs.ROUNDS
    ring = ring_graph(n)

    def clean(sched):   # two arms on one schedule
        return {"mixing_gossip_stacked": 2 * stream_comm_steps(sched),
                "tick_tail_stacked": 2 * stream_ticks(sched)}

    lossy = stream_comm_steps(qs.lossy_world(ring).compile(rounds, seed=0))
    heal = sum(stream_comm_steps(qs.sign_flip_world(ring, d).compile(
        rounds, seed=0)) for d in (None, AdaptiveDefense()))
    sweep = worlds_comm_steps(qs.sweep_worlds(n).compile(rounds))
    return {"calm": clean(World(topology=ring).compile(rounds, seed=0)),
            "hostile": clean(qs.hostile_world(n, rounds).compile(
                rounds, seed=0)),
            "lossy": {"channel_gossip_stacked": 2 * lossy},
            "self_healing": {"channel_gossip_stacked": heal},
            "sweep": {"mixing_gossip_worlds": sweep}}


def timed_path(dev, run):
    """``run()`` as one main path: the launch counts set to 0 just before
    and read just after, its standard output captured; returns (its
    result, wall s, launches, the non-empty lines it printed)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    printed = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        out = run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return out, wall, launches, [x for x in printed.getvalue().split("\n")
                                 if x]


def require_launched(launches: dict, expect: dict, what: str) -> None:
    """Each kernel of ``expect`` launched exactly its count and no other
    kernel launched (``expect`` empty: nothing launched at all); the
    weight products' launches join the tally."""
    got = {k: v for k, v in launches.items() if v or k in expect}
    require_products(launches, expect.get(DENSE, 0), what)
    require(got == expect,
            f"{what}: launches {launches}, expected {expect} alone")


@contextlib.contextmanager
def held_ticks(held: list):
    """Inside, the first ``FlatGossipEngine.tick`` on CUDA buffers of each
    leaf geometry and dynamics (mix or none) is held against the plain
    version on the same tensors, with the gradient leaves the replay gave
    it: x and x~ bit for bit (a NaN where the plain version has one), the
    padding columns 0, the row within TICK_ROW_RTOL (non-finite where the
    plain row is).  Each held call appends (workers, D, leaves, mix, max
    abs err, row gap) to ``held``; every other call runs as it would."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels.a2cid2_mixing import kernel as tk
    real, seen = engine_mod.tick_tail, set()

    def tick_tail(x, x_tilde, leaves, offsets, gscale, coeff, *, gamma,
                  backend="auto"):
        key = (tuple(tk._tick_geometry(x, leaves, offsets)), x.dtype,
               coeff is None) if x.is_cuda and backend == "auto" else None
        if key is None or key in seen:
            return real(x, x_tilde, leaves, offsets, gscale, coeff,
                        gamma=gamma, backend=backend)
        seen.add(key)
        want = real(x, x_tilde, leaves, offsets, gscale, coeff, gamma=gamma,
                    backend="ref")
        got = real(x, x_tilde, leaves, offsets, gscale, coeff, gamma=gamma)
        w, d = x.shape
        d_real = max((o + leaf.numel() // w for o, leaf in zip(offsets,
                                                                leaves)),
                     default=0)
        err = 0.0
        for a, r in zip(got[:2], want[:2]):
            require(bool(((a == r) | (a.isnan() & r.isnan())).all()),
                    f"tick_tail_stacked ({w}, {d}), {len(leaves)} leaves: "
                    f"x or x~ parts from the plain version")
            require(not a[:, d_real:].any(),
                    f"tick_tail_stacked ({w}, {d}): a padding column moved")
            fin = torch.isfinite(r)
            err = max(err, float(torch.where(fin, a - r, 0).abs().max()))
        gap = 0.0
        for a, r in zip(got[2:], want[2:]):
            a, r = float(a), float(r)
            require(math.isfinite(a) == math.isfinite(r),
                    f"tick_tail_stacked ({w}, {d}): row {a} against {r}")
            if math.isfinite(r):
                gap = max(gap, abs(a - r) / max(abs(r), 1e-30))
        require(gap <= TICK_ROW_RTOL,
                f"tick_tail_stacked ({w}, {d}): the row parts by {gap:.3e}")
        held.append((w, d, len(leaves), coeff is not None, err, gap))
        return got

    engine_mod.tick_tail = tick_tail
    try:
        yield
    finally:
        engine_mod.tick_tail = real


def print_lines(card, twin, printed, lines) -> None:
    """The lines a twin printed, prefixed; they must be the lines its
    result holds."""
    want = [x for line in lines for x in line.split("\n") if x]
    require(printed == want, f"{twin} printed {printed}, expected {want}")
    for line in printed:
        print(f"[{card}] {twin}: {line}")


def arm_rows(t: torch.Tensor, lead: int) -> torch.Tensor:
    """A leaf's (worker, or world and worker) rows, each flattened."""
    return t.float().reshape(math.prod(t.shape[:lead]), -1)


def same_replay(eng, ref, what: str, lead: int = 1) -> tuple[float, float]:
    """A twin's arm (``state``, ``trace``) replayed through the kernels
    against the same arm on the per-event path (the plain path, no hand
    kernel), both on the card: x and x~ finite-or-not exactly, then each
    worker's row within ENGINE_TOL of that row's largest magnitude (an
    undefended lossy arm's rows grow to ~1e12 beside far smaller ones);
    the loss and consensus traces likewise, at rtol ENGINE_TOL, atol 1e-6
    on the finite entries.  ``lead`` is 2 for world-batched states.
    Returns (the max abs err of x and x~, their bitwise share)."""
    from repro_torch.core.tree import tree_leaves
    err, same, total = 0.0, 0, 0
    for part in ("x", "x_tilde"):
        for a, r in zip(tree_leaves(getattr(eng.state, part)),
                        tree_leaves(getattr(ref.state, part))):
            a, r = arm_rows(a, lead), arm_rows(r, lead)
            fin = torch.isfinite(r)
            require(torch.equal(torch.isfinite(a), fin),
                    f"{what} {part}: finite entries differ")
            scale = torch.where(fin, r, 0).abs().amax(1, keepdim=True)
            d = torch.where(fin, a - r, 0).abs()
            require(bool((d <= ENGINE_TOL * scale).all()),
                    f"{what} {part}: a row parts by more than "
                    f"{ENGINE_TOL:g} of its largest magnitude")
            err = max(err, float(d.max()))
            same += int(((a == r) | (a.isnan() & r.isnan())).sum())
            total += a.numel()
    for name in ("loss", "consensus"):
        a, r = getattr(eng.trace, name), getattr(ref.trace, name)
        fin = torch.isfinite(r)
        require(torch.equal(torch.isfinite(a), fin),
                f"{what} {name}: finite entries differ")
        torch.testing.assert_close(a[fin], r[fin], rtol=ENGINE_TOL,
                                   atol=1e-6, msg=f"{what} {name}")
    return err, same / total


def check_worlds_clean(card, pw, b: int, w: int, d: int, d_real: int, gen
                       ) -> float:
    """``mixing_gossip_worlds`` against its plain version at f32 on (b, w,
    d) buffers with the per-world dynamics ``pw``, idle rows in every
    matching; the padding columns stay 0.  Returns the max abs err."""
    from repro_torch.kernels.a2cid2_mixing import kernel as k
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_worlds
    dev = torch.device("cuda")
    partner = torch.stack([torch.from_numpy(involution(w, idle=w // 4,
                                                       seed=d + i))
                           for i in range(b)]).to(dev)
    x, xt = (torch.randn(b, w, d, generator=gen, device=dev)
             for _ in range(2))
    x[:, :, d_real:] = 0
    xt[:, :, d_real:] = 0
    dt = torch.rand(b, w, generator=gen, device=dev) * 1.5
    rx, rxt = gossip_event_worlds(x, xt, partner, dt, *pw, backend="ref")
    kx, kxt = k.mixing_gossip_worlds(x, xt.clone(), partner, dt, *pw)
    torch.cuda.synchronize()
    err = max((kx - rx).abs().max().item(), (kxt - rxt).abs().max().item())
    require(err <= F32_TOL, f"mixing_gossip_worlds ({b}, {w}, {d}): max abs "
                            f"err {err} (tolerance {F32_TOL:g})")
    require(bool((kx[:, :, d_real:] == 0).all()
                 and (kxt[:, :, d_real:] == 0).all()),
            f"mixing_gossip_worlds ({b}, {w}, {d}): padding columns not 0")
    print(f"[{card}] worlds kernel vs plain torch.float32 ({b}, {w}, {d}): "
          f"max abs err {err:.3e} (tolerance {F32_TOL:g}); {d - d_real} "
          f"padding columns stay 0")
    return err


def example_kernel_checks(card, paths) -> dict:
    """Each kernel of phase 30b against its plain version at every (shape,
    dynamics) a twin's path launched it at, f32 as the twins run: ``paths``
    holds (kernel, workers, FlatLayout, dynamics or per-world dynamics).
    The clean kernel bit for bit (EXACT), the channel and worlds kernels
    at F32_TOL, as phases 1, 4 and 5 hold them.  Returns each kernel's max
    abs err."""
    from repro_torch.kernels.a2cid2_mixing.kernel import mixing_gossip_stacked
    from repro_torch.kernels.a2cid2_mixing.ops import gossip_event_stacked

    def plain(*args, **kw):
        return gossip_event_stacked(*args, backend="ref", **kw)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    errs = {}
    for name, w, layout, dyn in paths:
        d, d_real = layout.d, layout.d_real
        if name == "mixing_gossip_stacked":
            e, _ = check_kernel(card, mixing_gossip_stacked, plain, dyn, w, d,
                                d_real, torch.float32, EXACT, gen,
                                idle=w // 4)
        elif name == "channel_gossip_stacked":
            e, _ = check_channel(card, dyn, w, d, d_real, torch.float32,
                                 F32_TOL, gen, False)
        else:
            e = check_worlds_clean(card, dyn, dyn[0].numel(), w, d, d_real,
                                   gen)
        errs[name] = max(errs.get(name, 0.0), e)
        torch.cuda.empty_cache()
    return errs


def algo_dyn(p) -> dict:
    """The kernels' dynamics arguments of an ``A2CiD2Params``."""
    return dict(eta=p.eta, alpha=p.alpha, alpha_t=p.alpha_tilde)


def lm_full_main(lm, dev, argv):
    """``lm_decentralized``'s ``main`` on ``argv`` with a stream whose
    entropy rate is not computed (the header reads ``bayes CE nan``): at
    V = 32,000 it is 200 products of a vector with an 8.2 GB f64 matrix
    in numpy on the host, which is no work of the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMTaskStream

    class NoEntropyRate(LMTaskStream):
        def bayes_ce(self) -> float:
            return float("nan")

    args = lm.build_parser().parse_args(argv)
    cfg = get_config("nano-lm", reduced=not args.full)
    stream = NoEntropyRate(vocab_size=cfg.vocab_size,
                           seq_len=args.seq_len, batch_size=args.batch_size,
                           concentration=0.15, device=dev)
    header, out = lm.run(args, stream=stream)
    print(header, flush=True)
    for arm in out.values():
        print(arm.line, flush=True)
    return header, out


def phase_examples(card, dev=None) -> tuple[dict, dict]:
    """30b: the four example twins at their defaults, in this process,
    each path (each quickstart section) driven with the launch counts set
    to 0 just before it and read just after; then ``lm_decentralized
    --full --rounds 4`` and ``python -m repro_torch.examples.quickstart``
    in a subprocess.  Each quickstart section and the CIFAR arms are
    replayed again on the per-event path and held against the kernels'
    replay (``same_replay``), and each kernel is held against its plain
    version at every shape and dynamics the paths launched it at
    (``example_kernel_checks``; the tick tail, which the clean paths
    launch once a gradient tick, inside the paths on the gradients the
    replay gave it, ``held_ticks``).  Returns the launches of the paths
    and each kernel's max abs err."""
    from repro_torch.core import (Simulator, Telemetry, build_graph,
                                  params_from_graph, ring_graph)
    from repro_torch.configs import get_config
    from repro_torch.core.flatbuf import FlatLayout
    from repro_torch.examples import cifar_decentralized as cifar
    from repro_torch.examples import lm_decentralized as lm
    from repro_torch.examples import quickstart as qs
    from repro_torch.examples import serve_lm, two_arms
    dev = dev or torch.device("cuda")
    flag = ["--device", dev.type]
    total = {name: 0 for name in KERNELS}
    walls = {}
    paths = []   # (kernel, workers, layout, dynamics) for the checks
    ticks = []   # the tick tail's held calls (held_ticks)

    def count(launches):
        for name, n in launches.items():
            total[name] += n

    def held_both(start: int, what: str) -> None:
        """A clean path's baseline (eta 0) and A2CiD2 arms each had a tick
        held since ``ticks[start]``."""
        mixes = {m for _, _, _, m, _, _ in ticks[start:]}
        require(dev.type != "cuda" or mixes == {False, True},
                f"{what}: the tick tail was held with mix {mixes}")

    # -- quickstart, a path a section
    expect = quickstart_paths(qs)
    sections = {}
    b = qs.draw_b()
    for name, want in expect.items():
        start = len(ticks)
        with held_ticks(ticks):
            out, wall, launched, printed = timed_path(
                dev, lambda name=name: qs.print_section(
                    qs.SECTIONS[name](b, qs.NOISE, qs.ROUNDS, dev)))
        require_launched(launched, want, f"quickstart {name}")
        if "tick_tail_stacked" in want:
            held_both(start, f"quickstart {name}")
        count(launched)
        sections[name] = out
        walls[f"quickstart {name}"] = wall
        print_lines(card, "quickstart", printed, out.lines)
        print(f"[{card}] phase 30b: quickstart {name}: {wall:.2f} s, "
              + ", ".join(f"{k} x {n}" for k, n in want.items())
              + " (once a comm step"
              + (", the tick tail once a gradient tick,"
                 if "tick_tail_stacked" in want else "")
              + " of its streams)")
        ref = qs.SECTIONS[name](b, qs.NOISE, qs.ROUNDS, dev, engine=False)
        held = {arm: same_replay(out.runs[arm], ref.runs[arm],
                                 f"quickstart {name} {arm}",
                                 lead=2 if name == "sweep" else 1)
                for arm in out.runs}
        print(f"[{card}] phase 30b: quickstart {name} against its "
              f"per-event replay on the card (rows within {ENGINE_TOL:g} "
              f"of their largest magnitude): x, x~ max abs err, bitwise "
              f"share: " + "; ".join(f"{arm} {e:.3e}, {sh:.4%}"
                                     for arm, (e, sh) in held.items()))
        del ref
    ring = ring_graph(qs.N_WORKERS)
    quad = FlatLayout.from_pytree(sections["calm"].runs["A2CiD2"].state.x,
                                  stacked=True)
    accel = params_from_graph(ring, accelerated=True)
    paths += [("mixing_gossip_stacked", qs.N_WORKERS, quad,
               algo_dyn(params_from_graph(ring, accelerated=False))),
              ("mixing_gossip_stacked", qs.N_WORKERS, quad, algo_dyn(accel)),
              ("channel_gossip_stacked", qs.N_WORKERS, quad,
               algo_dyn(accel)),
              ("mixing_gossip_worlds", qs.N_WORKERS, quad,
               Simulator.world_params(
                   [accel] * qs.sweep_worlds(qs.N_WORKERS).size, dev))]
    calm = sections["calm"].runs
    require(float(calm["A2CiD2"].trace.consensus[-1])
            < float(calm["baseline"].trace.consensus[-1]),
            "quickstart: A2CiD2's consensus is not below the baseline's")
    heal = sections["self_healing"].runs
    require(heal["adaptive defense"].number >= 1,
            "quickstart: the adaptive defense rejected nothing")
    # the static trim: 0 rejected reads, counted by a telemetry replay of
    # its world, bit for bit the section's arm
    sim = Simulator(
        qs.quadratic_grad(0.2 * qs.draw_b()[0].to(dev), qs.NOISE),
        params_from_graph(ring, accelerated=True), gamma=qs.GAMMA,
        robust_clip=5.0, robust_rule="trim", device=dev)
    world = dataclasses.replace(qs.sign_flip_world(ring, None),
                                telemetry=Telemetry())
    tfinal, ttrace = sim.run_world(qs._start(sim, qs.N_WORKERS, qs.DIM),
                                   world, qs.ROUNDS, seed=0)
    rejected = float(ttrace.telemetry.rejected.sum())
    require(rejected == 0 and heal["static trim"].number == 0
            and torch.equal(tfinal.x, heal["static trim"].state.x),
            f"quickstart: the static trim rejected {rejected} reads or "
            f"parted from its telemetry replay")
    print(f"[{card}] phase 30b: quickstart gates: A2CiD2 "
          f"{float(calm['A2CiD2'].trace.consensus[-1]):.4f} < baseline "
          f"{float(calm['baseline'].trace.consensus[-1]):.4f}; adaptive "
          f"defense rejected {heal['adaptive defense'].number:.0f}; static "
          f"trim 0 (telemetry replay: {rejected:.0f} rejected, x bit for "
          f"bit)")
    del sections, calm, heal

    # -- the two trainers: the clean kernel once a comm step of each arm
    for twin, mod, argv, rounds in (
            ("cifar_decentralized", cifar, [], 25),
            ("lm_decentralized", lm, [], 200),
            ("lm_decentralized --full", lm, ["--full", "--rounds", "4"], 4)):
        args = mod.build_parser().parse_args(flag + argv)
        graph = build_graph(getattr(args, "graph", "ring"), args.workers)
        worlds, sched = two_arms(graph, args.rounds, args.seed)
        n, n_ticks = 2 * stream_comm_steps(sched), 2 * stream_ticks(sched)
        require(args.rounds == rounds, f"{twin}: {args.rounds} rounds")
        want = {"mixing_gossip_stacked": n, "tick_tail_stacked": n_ticks}
        if mod is lm and dev.type == "cuda":
            want[DENSE] = n_ticks * 3 * weight_products(
                get_config("nano-lm", reduced=not args.full),
                args.batch_size, args.seq_len)
        if getattr(args, "full", False):
            def twin_main():
                return lm_full_main(lm, dev, flag + argv)
        else:
            def twin_main():
                return mod.main(flag + argv)
        start = len(ticks)
        with held_ticks(ticks):
            out, wall, launched, printed = timed_path(dev, twin_main)
        require_launched(launched, want, twin)
        held_both(start, twin)
        count(launched)
        walls[twin] = wall
        arms = out if mod is cifar else out[1]
        for kind, arm in arms.items():
            require(bool(torch.isfinite(arm.trace.loss).all()),
                    f"{twin} {kind}: non-finite loss")
        print_lines(card, twin, printed, ([] if mod is cifar else [out[0]])
                    + [arm.line for arm in arms.values()])
        print(f"[{card}] phase 30b: {twin}: {wall:.2f} s, "
              f"mixing_gossip_stacked x {n} (2 arms x {n // 2} comm steps)"
              f", tick_tail_stacked x {n_ticks} (2 arms x {n_ticks // 2} "
              f"gradient ticks), gemm_3xtf32 x {want.get(DENSE, 0)} (3 a "
              f"weight product a tick), losses finite")
        layout = FlatLayout.from_pytree(arms["a2cid2"].state.x, stacked=True)
        paths += [("mixing_gossip_stacked", args.workers, layout,
                   algo_dyn(world.algorithm_params()))
                  for world in worlds.values()]
        if mod is cifar:
            ref = cifar.run(args, engine=False)
            held = {kind: same_replay(arms[kind], ref[kind],
                                      f"{twin} {kind}") for kind in arms}
            print(f"[{card}] phase 30b: {twin} against its per-event replay"
                  f" on the card (rows within {ENGINE_TOL:g} of their "
                  f"largest magnitude, loss trace at rtol {ENGINE_TOL:g}):"
                  f" x, x~ max abs err, bitwise share: "
                  + "; ".join(f"{kind} {e:.3e}, {sh:.4%} (test acc "
                              f"{arms[kind].test_acc:.2f} / "
                              f"{ref[kind].test_acc:.2f})"
                              for kind, (e, sh) in held.items()))
            del ref
        del out, arms
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the serving fleet: the per-event replay, no hand kernel
    rep, wall, launched, printed = timed_path(dev,
                                              lambda: serve_lm.main(flag))
    require_launched(launched, {}, "serve_lm")
    require(rep.lost == 0 and rep.restarted >= 1,
            f"serve_lm: lost {rep.lost}, restarted {rep.restarted}")
    walls["serve_lm"] = wall
    print_lines(card, "serve_lm", printed, serve_lm.report_lines(rep))
    print(f"[{card}] phase 30b: serve_lm: {wall:.2f} s, no hand kernel, "
          f"lost 0, restarted {rep.restarted}")
    del rep

    # -- each kernel against its plain version at the paths' shapes
    errs = example_kernel_checks(card, paths) if dev.type == "cuda" else {}
    print(f"[{card}] phase 30b: kernels against their plain versions at the"
          f" twins' shapes and dynamics ("
          + ", ".join(sorted({f"{k} ({'6, ' if 'worlds' in k else ''}{w}, "
                              f"{lay.d})" for k, w, lay, _ in paths}))
          + "): max abs err " + ", ".join(f"{k} {e:.3e}"
                                          for k, e in errs.items()))
    if dev.type == "cuda":
        errs["tick_tail_stacked"] = max(e for *_, e, _ in ticks)
        print(f"[{card}] phase 30b: tick_tail_stacked against its plain "
              f"version in the clean paths, at the first tick of each leaf "
              f"geometry and dynamics, on the gradients the replay gave it "
              f"(x, x~ bit for bit, the row within {TICK_ROW_RTOL:g}): "
              + "; ".join(f"({w}, {d}) {n} leaves {'mix' if m else 'eta 0'}"
                          f" row {g:.3e}" for w, d, n, m, _, g in ticks))

    # -- the module alone, on the card by default
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m",
                          "repro_torch.examples.quickstart"]
                         + ([] if dev.type == "cuda" else flag),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    lines = [x for x in run.stdout.splitlines() if x]
    require(run.returncode == 0 and len(lines) == 19
            and lines[0].startswith("ring graph: chi1="),
            f"python -m repro_torch.examples.quickstart: rc "
            f"{run.returncode}, {len(lines)} lines; {run.stderr[-2000:]}")
    walls["quickstart (subprocess)"] = wall
    print(f"[{card}] phase 30b: python -m repro_torch.examples.quickstart "
          f"(no flags, its own process): rc 0, {len(lines)} lines in "
          f"{wall:.2f} s")
    print(f"[{card}] phase 30b: wall s " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()))
    return total, errs


# the LM cell's model (perfbench's qwen3_0_6b: Qwen3-0.6B at 10 of its 28
# layers, f32) and workers, for phase 31's second shape
LM_CELL_LAYERS, LM_CELL_WORKERS = 10, 4
TICK_REPS = {"resnet": 20, "lm": 6}
# the row: the kernel adds each column's squares in double, the eager sums
# in f32 in another order
TICK_ROW_RTOL = 1e-6


def lm_cell_tree(dev, w: int, gen) -> dict:
    """Random stacked leaves (w, *shape) of the LM cell's model, f32,
    contiguous as its gradient function leaves them."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Block, uniform_blocks
    from repro_torch.models.layers import SHAPE_ONLY
    from repro_torch.models.transformer import Model
    from repro_torch.core.tree import tree_map
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              blocks=uniform_blocks(Block("attn", "dense"),
                                                    LM_CELL_LAYERS))
    shapes = Model(cfg).init(SHAPE_ONLY)
    return tree_map(lambda a: torch.randn((w,) + tuple(a.shape),
                                          generator=gen, device=dev), shapes)


def tick_case(engine, x, gen, dt_scale: float = 1.0):
    """(bx, bxt, gscale, dt_next) for one tick from a stacked state: x~ a
    little off x, one row masked, the gaps drawn."""
    w = engine.layout.treedef.flatten_up_to(x)[0].shape[0]
    bx = engine.pack(x)
    bxt = bx + 1e-3 * torch.randn(bx.shape, generator=gen, device=bx.device)
    bxt[:, engine.layout.d_real:] = 0
    gscale = torch.ones(w, device=bx.device)
    gscale[w // 2] = 0.0
    dt = dt_scale * torch.rand(w, generator=gen, device=bx.device)
    return bx, bxt, gscale, dt


def phase_tick_tail(card, params0, cfg, stream_cls, grad_fn_for):
    """Phase 31: ``tick_tail_stacked`` against its plain version and timed
    at the two cells' shapes.  Returns (the kernel's JSON row, its
    launches)."""
    from repro_torch.core import FlatGossipEngine, Simulator
    from repro_torch.core import params_from_graph, ring_graph
    from repro_torch.kernels.a2cid2_mixing import kernel as tk
    from repro_torch.kernels.a2cid2_mixing.ops import tick_tail
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    reset_launches()
    row, worst, err = {}, 0.0, 0.0
    for label, w in (("resnet", N_WORKERS), ("lm", LM_CELL_WORKERS)):
        dyn = params_from_graph(ring_graph(w), True)
        if label == "resnet":
            sim = Simulator(grad_fn_for(cfg, stream_cls(batch_size=BATCH)),
                            dyn, GAMMA)
            state = sim.init(params0, w, gen)
            engine = FlatGossipEngine.for_pytree(state.x, dyn)
            _, grads = sim.grad_fn(state.x, state.generator,
                                   torch.arange(w, device=dev))
            x = state.x
            del state
        else:
            x = lm_cell_tree(dev, w, gen)
            engine = FlatGossipEngine.for_pytree(x, dyn)
            grads = lm_cell_tree(dev, w, gen)
        bx, bxt, gscale, dt = tick_case(engine, x, gen)
        del x
        leaves = engine.layout.treedef.flatten_up_to(grads)
        offsets = [sp.offset for sp in engine.layout.specs]
        geometry = tk._tick_geometry(bx, leaves, offsets)
        table, _, (_, _, blocks) = tk.plan_tick(tuple(geometry), bx.dtype,
                                                w, engine.layout.d)
        kinds = {k: int((table["kind"] == v).sum())
                 for k, v in (("vec", tk.KIND_VEC), ("runs", tk.KIND_RUNS))}
        # the plain version on the same tensors first: the kernel writes
        # bx and bxt in place
        coeff = 0.5 * (1.0 - torch.exp(-2.0 * dyn.eta * dt))
        want = tick_tail(bx, bxt, leaves, offsets, gscale, coeff,
                         gamma=GAMMA, backend="ref")
        got = engine.tick(bx, bxt, grads, gscale, GAMMA, dt)
        torch.cuda.synchronize()
        require(got[0] is bx and got[1] is bxt,
                f"{label}: the tick's outputs are not the input buffers")
        err = max(err, *(float((g - e).abs().max())
                          for g, e in zip(got[:2], want[:2])))
        require(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1]),
                f"{label}: x or x~ parts from the plain version by {err}")
        d_real = engine.layout.d_real
        require(not got[0][:, d_real:].any() and not got[1][:, d_real:].any(),
                f"{label}: a padding column moved")
        gaps = [abs(float(g) - float(e)) / max(abs(float(e)), 1e-30)
                for g, e in zip(got[2:], want[2:])]
        require(max(gaps) <= TICK_ROW_RTOL,
                f"{label}: the row parts from the plain version by {gaps}")
        worst = max(worst, max(gaps))
        del want, got

        sim = Simulator(lambda *a: (torch.zeros(w, device=dev), grads), dyn,
                        GAMMA)
        ids = torch.arange(w, device=dev)

        def fused():
            return engine.tick(bx, bxt, grads, gscale, GAMMA, dt)

        def eager():
            ox, oxt, _ = sim._grad_tick(engine, bx, bxt, None, gscale, ids)
            return engine.mix(ox, oxt, dt)

        reps = TICK_REPS[label]
        kernel_ms = cuda_ms(fused, reps)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        eager_ms = cuda_ms(eager, reps)
        eager_peak = torch.cuda.max_memory_allocated() - base_mem
        nbytes = (sum(g.numel() * g.element_size() for g in leaves)
                  + 4 * bx.numel() * bx.element_size())
        b = bound(nbytes, 0)
        require(kernel_ms >= b["bound_ms"],
                f"{label}: {kernel_ms:.4f} ms is below the bytes bound "
                f"{b['bound_ms']:.4f} ms: the bytes are miscounted")
        row[label] = {"ms": kernel_ms, "plain_ms": eager_ms, **b}
        print(f"[{card}] phase 31: tick_tail_stacked {label} (W, D) = "
              f"({w}, {engine.layout.d}) {bx.dtype}, "
              f"{len(leaves)} leaves ({kinds['vec']} vectorised, "
              f"{kinds['runs']} through runs, "
              f"{sum(not g.is_contiguous() for g in leaves)} strided), "
              f"{len(blocks)} launch(es) of {blocks.tolist()} blocks: "
              f"x, x~ bit for bit the plain version (max abs err "
              f"{err:.3e}), padding 0, the row within {max(gaps):.3e} "
              f"(limit {TICK_ROW_RTOL:g}); kernel {kernel_ms:.4f} ms against "
              f"the bytes bound {b['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} "
              f"GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s: "
              f"{b['bound_ms'] / kernel_ms:.1%} of it, "
              f"{nbytes / kernel_ms / 1e9:.2f} TB/s), the eager sequence "
              f"{eager_ms:.4f} ms ({eager_ms / kernel_ms:.2f}x the kernel; "
              f"{eager_peak / 2**30:.2f} GiB of temporaries)")
        del bx, bxt, grads, leaves, sim
        torch.cuda.empty_cache()
    launched = read_launches()
    require(only_launched(launched, "tick_tail_stacked"),
            f"phase 31 launched {launched}")
    # the main path's shape (the LM cell's) in the common keys, ResNet's
    # beside them
    lm, resnet = row["lm"], row["resnet"]
    return ({"max_abs_err": err, "ms": lm["ms"], "plain_ms": lm["plain_ms"],
             "bound_ms": lm["bound_ms"], "bound_by": lm["bound_by"],
             "library_ms": None, "row_rel_err": worst,
             "resnet_ms": resnet["ms"], "resnet_plain_ms": resnet["plain_ms"],
             "resnet_bound_ms": resnet["bound_ms"]},
            launched["tick_tail_stacked"])


# phase 32: the dropless experts at the Kanana-2 cell's shape: 4 workers
# of one 1,024-token sequence, top-6 of 128 experts, 8 held, d 2048,
# expert width 768
MOE_CELL = dict(w=4, t=1024, k=6, e=128, n=8, d=2048, f=768)
MOE_REPS = 20
# kernel against the dense plain version, f32 both (FFMA against cuBLAS
# with TF32 off): relative to each output's largest value
MOE_RTOL = 1e-5


def phase_moe_experts(card):
    """Phase 32: ``moe_experts`` (route, products, combine, backward)
    against the dense plain version at the cell's shape, timed beside its
    bound and the plain version's forward and backward.  Returns (the
    kernel's JSON row, its launches)."""
    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.kernels.moe_experts.ops import flops_per_row, least_bytes
    from repro_torch.kernels.moe_experts.ref import moe_experts_ref
    dev = torch.device("cuda")
    c = MOE_CELL
    w, t, k, e, n, d, f = (c[key] for key in "wtkend" + "f")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    ids = torch.rand((w, t, e), generator=gen, device=dev).argsort(
        -1)[..., :k].contiguous()
    gates = torch.rand((w, t, k), generator=gen, device=dev)
    x = torch.randn((w, t, d), generator=gen, device=dev)
    wg = torch.randn((w, n, d, f), generator=gen, device=dev) / d ** 0.5
    wu = torch.randn((w, n, d, f), generator=gen, device=dev) / d ** 0.5
    wd = torch.randn((w, n, f, d), generator=gen, device=dev) / f ** 0.5
    dout = torch.randn((w, t, d), generator=gen, device=dev)
    reset_launches()
    before = dict(mk.moe_experts.by_op)

    def forward():
        meta, row, pick = mk.route(ids, 0, n, w * t * min(k, n))
        hg, hu, y = mk.products(x, gates, meta, row, pick, wg, wu, wd, 0)
        return (mk.combine(y, gates, row, t), meta, row, pick, hg, hu, y)

    out, meta, row, pick, hg, hu, y = forward()
    grads = mk.backward(dout, x, gates, meta, row, pick, wg, wu, wd, hg, hu,
                        y, 0)
    by_op = {op: mk.moe_experts.by_op.get(op, 0) - before.get(op, 0)
             for op in mk.OPS}
    require(by_op == {op: 1 for op in mk.OPS},
            f"phase 32: launches by op {by_op}")
    ins = [a.clone().requires_grad_() for a in (x, gates, wg, wu, wd)]
    want = moe_experts_ref(ins[0], ids, ins[1], *ins[2:], 0)
    want_g = torch.autograd.grad(want, ins, dout)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip((out, *grads), (want, *want_g))]
    require(max(errs) <= MOE_RTOL,
            f"phase 32: kernel vs plain, relative errors {errs}")
    rows = int(meta[:, n:].sum())
    largest = int(meta[:, n:].max())
    del want, want_g, ins

    def backward():
        return mk.backward(dout, x, gates, meta, row, pick, wg, wu, wd, hg,
                           hu, y, 0)

    def plain():
        ins = [a.detach().requires_grad_() for a in (x, gates, wg, wu, wd)]
        return torch.autograd.grad(
            moe_experts_ref(ins[0], ids, ins[1], *ins[2:], 0), ins, dout)

    fwd_ms = cuda_ms(forward, MOE_REPS)
    bwd_ms = cuda_ms(backward, MOE_REPS)
    plain_ms = cuda_ms(plain, 5)
    ms = fwd_ms + bwd_ms
    flops = rows * flops_per_row(d, f)
    nbytes = least_bytes(rows, w, t, n, d, f)
    b = bound(nbytes, flops)
    require(ms >= b["bound_ms"],
            f"phase 32: {ms:.4f} ms is below the bound {b['bound_ms']:.4f} "
            f"ms: the work is miscounted")
    launched = read_launches()
    require(only_launched(launched, "moe_experts"),
            f"phase 32 launched {launched}")
    print(f"[{card}] phase 32: moe_experts at (W, T, K, E, n, D, F) = "
          f"({w}, {t}, {k}, {e}, {n}, {d}, {f}): {rows} held rows (largest "
          f"group {largest}, {w * n} groups), out and the five gradients "
          f"within {max(errs):.2e} of the dense plain version's largest "
          f"values (limit {MOE_RTOL:g}); forward (route, 2 products, "
          f"combine) {fwd_ms:.4f} ms, backward (6 launches) {bwd_ms:.4f} ms, "
          f"together {ms:.4f} against the bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} "
          f"GB; {b['bound_ms'] / ms:.1%} of it); the dense plain version "
          f"forward and backward {plain_ms:.4f} ms "
          f"({plain_ms / ms:.2f}x)")
    return ({"max_abs_err": max(errs), "ms": ms, "forward_ms": fwd_ms,
             "backward_ms": bwd_ms, "plain_ms": plain_ms,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None, "rows": rows},
            launched["moe_experts"])

# phase 33: the product shapes of the two LM cells, (W, M, N, K, A K-major,
# B K-major): Y = X W (X K-major, W N-major), dX = dY W^T (both K-major),
# dW = X^T dY (both M/N-major); the tied head's dW as (dY^T X)^T
DENSE_SHAPES = [
    ("Qwen3 q fwd", 4, 1024, 2048, 1024, True, False),
    ("Qwen3 q dX", 4, 1024, 1024, 2048, True, True),
    ("Qwen3 q dW", 4, 1024, 2048, 1024, False, False),
    ("Qwen3 mlp up fwd", 4, 1024, 3072, 1024, True, False),
    ("Qwen3 mlp up dX", 4, 1024, 1024, 3072, True, True),
    ("Qwen3 mlp up dW", 4, 1024, 3072, 1024, False, False),
    ("Qwen3 mlp down fwd", 4, 1024, 1024, 3072, True, False),
    ("Qwen3 tied head fwd", 4, 1024, 152064, 1024, True, True),
    ("Qwen3 tied head dX", 4, 1024, 1024, 152064, True, False),
    ("Qwen3 tied head dW^T", 4, 152064, 1024, 1024, False, False),
    ("Kanana-2 q fwd", 4, 1024, 6144, 2048, True, False),
    ("Kanana-2 q dW", 4, 2048, 6144, 1024, False, False),
    ("Kanana-2 w_dkv fwd", 4, 1024, 576, 2048, True, False),
    ("Kanana-2 w_dkv dX", 4, 1024, 2048, 576, True, True),
    ("Kanana-2 w_dkv dW", 4, 2048, 576, 1024, False, False),
    ("Kanana-2 w_uk fwd", 4, 1024, 4096, 512, True, False),
    ("Kanana-2 head fwd", 4, 1024, 16128, 2048, True, False),
    ("Kanana-2 head dX", 4, 1024, 2048, 16128, True, True),
    ("Kanana-2 head dW", 4, 2048, 16128, 1024, False, False),
]
DENSE_REPS = 10
# kernel against torch.matmul (both off f64 by ~1e-7 of |A| |B|): the
# largest gap over the largest element of |A| |B|
DENSE_RTOL = 1e-6
# the f32 route on the tensor cores: three TF32 products a product
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3


def dense_operands(gen, w, m, n, k, a_kmajor, b_kmajor):
    """A (W, M, K) and B (W, K, N) in the given layouts, B a slice of a
    stack of 2 (a batch stride of 2 matrices), as the tick's leaves."""
    dev = torch.device("cuda")
    a = torch.randn((w, m, k) if a_kmajor else (w, k, m), generator=gen,
                    device=dev)
    b = torch.randn((w, 2, n, k) if b_kmajor else (w, 2, k, n),
                    generator=gen, device=dev)[:, 1] / math.sqrt(k)
    return (a if a_kmajor else a.transpose(1, 2),
            b.transpose(1, 2) if b_kmajor else b)


def dense_tick_launches(card, name: str) -> None:
    """One ``lm_grad_fn`` tick of a reduced block, 4 workers of 256
    tokens, with a tracer active: every weight product on the kernel,
    three launches each (Y, dX, dW), none on matmul."""
    from repro_torch.analysis.tracing import SpanTracer
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dense_f32.kernel import gemm_3xtf32
    from repro_torch.models.transformer import Model, lm_grad_fn
    dev = torch.device("cuda")
    if name == "Qwen3":
        from repro_torch.configs import get_config
        cfg = get_config("qwen3-0.6b", reduced=True)
    else:
        sys.path.insert(0, str(ROOT))
        from perfbench.models import mla_moe
        kcfg = json.loads((ROOT / "perfbench/configs/kanana2_30b_a3b.json")
                          .read_text())
        kcfg.update(hidden_size=256, num_attention_heads=4,
                    kv_lora_rank=32, qk_rope_head_dim=16,
                    qk_nope_head_dim=32, v_head_dim=32,
                    intermediate_size=512, moe_intermediate_size=64,
                    router_experts=16, n_routed_experts=4,
                    num_experts_per_tok=4, vocab_size=500,
                    num_hidden_layers=3)
        cfg = mla_moe.model_config(kcfg)
    model = Model(cfg)
    x = tree_map(lambda *a: torch.stack(a), *[
        model.init(torch.Generator(device=dev).manual_seed(i))
        for i in range(4)])

    class Stream:
        def sample_workers(self, gen, n):
            t = torch.randint(0, cfg.vocab_size, (n, 1, 257), generator=gen,
                              device=dev)
            return {"inputs": t[..., :-1], "labels": t[..., 1:]}

    before = gemm_3xtf32.launches
    tracer = SpanTracer("dense", device=dev)
    with tracer.activate():
        losses, _ = lm_grad_fn(model, Stream())(
            x, torch.Generator(device=dev).manual_seed(1),
            torch.arange(4, device=dev))
    torch.cuda.synchronize()
    tracer.resolve()
    launched = gemm_3xtf32.launches - before
    got = {k: 0.0 for k in ("kernel_products", "kernel_flops",
                            "matmul_products", "matmul_flops")}
    for ev in tracer.to_dict()["traceEvents"]:
        if ev.get("ph") == "C" and ev["name"] == "dense":
            for k in got:
                got[k] += ev["args"][k]
    require(bool(torch.isfinite(losses).all()), f"phase 33: {name} losses "
            f"{losses.tolist()}")
    require_products({DENSE: launched}, 3 * weight_products(cfg, 1, 256),
                     f"phase 33: a reduced {name} tick")
    require(got["matmul_products"] == 0
            and got["kernel_products"] == launched,
            f"phase 33: {name} tick: {launched} launches, counter {got}")
    print(f"[{card}] phase 33: a reduced {name} tick (4 workers of 256 "
          f"tokens): {launched} gemm_3xtf32 launches, every weight product "
          f"({got['kernel_flops'] / 1e9:.2f} GFLOP) on the kernel, none on "
          f"matmul")


def phase_dense_f32(card):
    """Phase 33: ``gemm_3xtf32`` at the LM cells' product shapes against
    ``torch.matmul`` and timed beside its bound, its SASS, and a reduced
    Qwen3 and Kanana-2 tick through it, each window's launches held to
    its count (``require_products``).  Returns the kernel's JSON row."""
    from repro_torch.kernels.build import lib_path
    from repro_torch.kernels.dense_f32.kernel import gemm_3xtf32
    lib = lib_path("gemm_3xtf32")
    sass = tensor_core_instructions(lib)
    if sass is None:
        print(f"[{card}] gemm_3xtf32 SASS: not measured (no cuobjdump)")
    else:
        require(sass["HGMMA"] > 0, f"gemm_3xtf32 without wgmma: {sass}")
        print(f"[{card}] gemm_3xtf32 SASS ({lib.name}): {sass['HGMMA']} "
              f"HGMMA, {sass['HMMA']} HMMA")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    reset_launches()
    rows, worst = [], 0.0
    for label, w, m, n, k, akm, bkm in DENSE_SHAPES:
        a, b = dense_operands(gen, w, m, n, k, akm, bkm)
        c = gemm_3xtf32(a, b)
        want = torch.matmul(a, b)
        err = float((c - want).abs().max()
                    / torch.matmul(a.abs(), b.abs()).max())
        worst = max(worst, err)
        require(err <= DENSE_RTOL, f"phase 33: {label}: {err:.3e} of the "
                f"largest |A| |B| from torch.matmul's")
        ms = cuda_ms(lambda: gemm_3xtf32(a, b), DENSE_REPS)
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), DENSE_REPS)
        flops = 2.0 * w * m * n * k
        nbytes = 4 * w * (m * k + k * n + m * n)
        bd = bound(nbytes, flops, PEAK_3XTF32_FLOPS)
        require(ms >= bd["bound_ms"], f"phase 33: {label} {ms:.4f} ms is "
                f"below its bound {bd['bound_ms']:.4f} ms")
        rows.append({"label": label, "ms": ms, "library_ms": lib_ms,
                     "bound_ms": bd["bound_ms"], "err": err})
        print(f"[{card}] phase 33: {label} (W, M, N, K) = ({w}, {m}, {n}, "
              f"{k}): {ms:.4f} ms, {bd['bound_ms'] / ms:.1%} of its bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s); torch.matmul {lib_ms:.4f} "
              f"ms ({lib_ms / ms:.2f}x); within {err:.2e}")
        del a, b, c, want
    launched = read_launches()
    require_products(launched, len(DENSE_SHAPES) * (DENSE_REPS + 3),
                     "phase 33's shapes")
    require(only_launched(launched, DENSE), f"phase 33 launched {launched}")
    for name in ("Qwen3", "Kanana-2"):
        dense_tick_launches(card, name)
    # the plain version (ref.py) is torch.matmul itself
    head = next(r for r in rows if r["label"] == "Qwen3 tied head fwd")
    return {"max_rel_err": worst, "ms": head["ms"],
            "bound_ms": head["bound_ms"], "bound_by": "operations",
            "plain_ms": head["library_ms"],
            "library_ms": head["library_ms"], "shapes": rows}


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
    # every kernel's launches over the phases, 0 until a phase adds some
    launches = {**dict.fromkeys(KERNELS, 0),
                **phase_slice(card, params0, cfg, SyntheticCIFAR,
                              resnet_grad_fn)}
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
    for name, n in lm_launches.items():   # phases 3 and 13
        launches[name] += n
    torch.cuda.empty_cache()
    phase_lm_engine_vs_reference(card, nano, stream)
    torch.cuda.empty_cache()
    launches["flash_attention_bhsd"] = phase_prefill(card, nano, consensus,
                                                     stream)
    del consensus   # the stream's (V, V) chain stays for phase 21
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
    # phases 19-20 hold two ResNet replays bit for bit against each other:
    # deterministic cuDNN algorithms from here on
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    tel = phase_telemetry(card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    torch.cuda.empty_cache()
    tel["channel_gossip_stacked"] += phase_run_world_ar(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    for name, n in tel.items():   # the telemetry paths (19, 20)
        launches[name] += n
    torch.cuda.empty_cache()
    phase_sync_train(card, stream)
    del stream
    print(f"[{card}] phases 1-21 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    qwen, qwen_params, qwen_step_ms = phase_decode(
        card, get_config("qwen3-0.6b"))
    phase_batching(card, qwen, qwen_params)
    del qwen, qwen_params
    torch.cuda.empty_cache()
    phase_fleet(card, get_config("nano-lm"))
    print(f"[{card}] phases 1-24 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    zoo = phase_zoo(card, qwen_step_ms)
    launches["flash_attention_bhsd"] += zoo["flash_attention_bhsd"]
    launches["mixing_gossip_stacked"] += zoo["mixing_gossip_stacked"]
    launches["tick_tail_stacked"] += zoo["tick_tail_stacked"]
    print(f"[{card}] phases 1-27 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    n28, err28 = phase_sharded(card, layout.d, params0, cfg, SyntheticCIFAR,
                               resnet_grad_fn)
    launches["channel_gossip_worlds"] += n28
    rows["channel_gossip_worlds"]["max_abs_err"] = max(
        rows["channel_gossip_worlds"]["max_abs_err"], err28)
    print(f"[{card}] phases 1-28 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    for name, n in phase_dryrun(card, params0, cfg, SyntheticCIFAR,
                                resnet_grad_fn).items():
        launches[name] += n
    print(f"[{card}] phases 1-29 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_rmsnorm_vjp(card)
    torch.cuda.empty_cache()
    example_launches, example_errs = phase_examples(card)
    for name, n in example_launches.items():
        launches[name] += n
    for name, e in example_errs.items():
        if name in rows:   # the tick tail's row comes in phase 31
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    print(f"[{card}] phase 30: {time.perf_counter() - t0:.1f} s")
    print(f"[{card}] phases 1-30 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    rows["tick_tail_stacked"], n31 = phase_tick_tail(
        card, params0, cfg, SyntheticCIFAR, resnet_grad_fn)
    rows["tick_tail_stacked"]["max_abs_err"] = max(
        rows["tick_tail_stacked"]["max_abs_err"],
        example_errs.get("tick_tail_stacked", 0.0))
    launches["tick_tail_stacked"] += n31
    print(f"[{card}] phases 1-31 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    rows["moe_experts"], n32 = phase_moe_experts(card)
    launches["moe_experts"] += n32
    print(f"[{card}] phases 1-32 done at {time.perf_counter() - t_start:.1f}"
          f" s")
    torch.cuda.empty_cache()
    rows["gemm_3xtf32"] = phase_dense_f32(card)
    # every checked window's weight products (``require_products``)
    launches["gemm_3xtf32"] = DENSE_TALLY["launches"]
    print(f"[{card}] phases 1-33 done at {time.perf_counter() - t_start:.1f}"
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
