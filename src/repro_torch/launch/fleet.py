"""Gossip-serving fleet: continuous-batching replicas that never stop
averaging (DESIGN.md §14), ported from ``repro.launch.fleet``.

The paper's core property — workers keep working while a p2p averaging
routine runs beside them — applied to INFERENCE: every replica of a
``GossipFleet`` is at once

  (a) a continuous-batching decode server (one ``SlotScheduler`` per
      replica, all replicas stepped by ONE ``torch.func.vmap``ped decode
      over the fleet's (W, D) flat parameter bank), and
  (b) a gossip worker in a declarative ``World``: its parameters drift
      (online fine-tuning ticks or injected perturbations) and re-contract
      through the compiled A²CiD²/ADPSGD event schedule.

The bank is ``FlatLayout``-packed, so the gossip side IS
``Simulator._round_channel``, the per-event channel replay, run one round
at a time on the single-leaf flat buffer: stale reads, drops, Byzantine
edges and robust aggregation apply to the fleet unchanged, and the fleet's
bank equals ``Simulator.run_schedule(engine=False)`` on the same schedule
bit for bit (tests/test_torch_fleet.py).

Timeline: round r = [gossip events of schedule round r] -> [one decode
step on every alive, un-stalled replica] -> [drift tick folded into the
same gossip round].  Churn kills (``ChurnProcess`` / ``PhaseSwitch``)
evict the dead replica's queued AND in-flight requests to the least-loaded
survivor; in-flight work restarts from scratch (its KV rows died with the
replica): counted as ``restarts``, never lost.

The drift draws of ``drift="perturb"`` come from a ``torch.Generator``
(seeded ``seed``), one (W, D) draw a round, where the JAX package draws a
row per replica from split keys: the same process, other values.  Prompts
and the arrival trace come from numpy and equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from ..core.a2cid2 import consensus_distance
from ..core.flatbuf import FlatLayout, ring_init
from ..core.simulator import Simulator
from ..core.tree import tree_leaves, tree_map
from ..core.world import World
from ..models.transformer import Model
from .batching import Request, SlotScheduler, gate_caches

# rng-stream tag for prompt-token draws: like the arrival trace, identical
# across every fleet sharing a seed (and equal to the JAX package's)
_PROMPT_TAG = 0x9A0527


def make_fleet_step(model: Model, layout: FlatLayout) -> Callable:
    """One greedy decode step for ALL replicas: unpack the (W, D) bank and
    ``vmap`` the per-replica slot-batch step over the replica axis.

    (bank (W, D), caches [leaves (W, repeat, B, ...)], tokens (W, B, 1)
    int32, positions (W, B) int32, active (W, B) bool)
    -> (next ids (W, B) int32, new caches).
    """
    vocab = model.cfg.vocab_size

    def one(params, caches, tokens, positions, active):
        logits, new_caches = model.decode_step(params, tokens, positions,
                                               caches)
        nxt = logits[:, 0, :vocab].argmax(dim=-1)
        # inactive slots fed padding must not touch their cache state: a
        # stalled replica's whole batch goes through as padding while its
        # slots hold in-flight KV rows
        return (torch.where(active, nxt, 0).to(torch.int32),
                gate_caches(active, caches, new_caches))

    batched = vmap(one)

    def step(bank, caches, tokens, positions, active):
        with torch.no_grad():
            return batched(layout.unpack(bank), caches, tokens, positions,
                           active)

    return step


def flat_grad_fn(layout: FlatLayout, tree_grad_fn: Callable) -> Callable:
    """Lift a batched pytree ``grad_fn(x_stacked, generator, ids) ->
    (losses (W,), grads)`` (the port's ``Simulator`` signature) onto the
    (W, D) bank: the online fine-tuning drift."""

    def fn(bank, generator, ids):
        losses, grads = tree_grad_fn(layout.unpack(bank), generator, ids)
        return losses, layout.pack(grads)

    return fn


def _perturb_grad(bank, generator, ids):
    """Injected-perturbation drift: a unit Gaussian "gradient" per replica
    and round, one (W, D) draw from ``generator``.  Replicas random-walk
    apart (scaled by the fleet's ``drift_scale`` through the simulator's
    gamma) unless gossip pulls them back."""
    return (torch.zeros(bank.shape[0], dtype=torch.float32,
                        device=bank.device),
            torch.randn(bank.shape, generator=generator, dtype=bank.dtype,
                        device=bank.device))


def _zero_grad(bank, generator, ids):
    return (torch.zeros(bank.shape[0], dtype=torch.float32,
                        device=bank.device), torch.zeros_like(bank))


@dataclasses.dataclass
class FleetReport:
    """What one ``GossipFleet.run`` produced."""

    requests_total: int
    completed: list                  # finished Requests (out/rounds filled)
    lost: int                        # never completed (drain cap / no fleet)
    restarted: int                   # churn re-admissions (degradation)
    latencies: np.ndarray            # (C,) decode-round latency per request
    ttft: np.ndarray                 # (C,) rounds from arrival to 1st token
    ttft_wait: np.ndarray            # (C,) rounds waiting for a slot
    ttft_decode: np.ndarray          # (C,) rounds streaming the prompt
    consensus: np.ndarray            # (R + drain,) consensus per round —
    #   gossip stops at round R, so the drain tail is constant by
    #   construction (the bank is frozen while queues empty)
    rounds: int                      # scheduled (gossip-active) rounds
    drain_rounds: int                # extra decode-only rounds to drain
    tokens_generated: int
    stall_skips: int                 # decode rounds skipped to pay comm debt
    wall_seconds: float
    final_bank: torch.Tensor         # (W, D) parameter bank after the run

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.latencies, p)) \
            if self.latencies.size else float("nan")

    def ttft_percentile(self, p: float) -> float:
        return float(np.percentile(self.ttft, p)) \
            if self.ttft.size else float("nan")

    @property
    def tokens_per_round(self) -> float:
        total = self.rounds + self.drain_rounds
        return self.tokens_generated / max(total, 1)

    def summary(self, hist_bins: int = 12) -> dict:
        """JSON-able digest for ``BENCH_serve.json``."""
        lat = self.latencies
        if lat.size:
            hist, edges = np.histogram(lat, bins=hist_bins)
        else:
            hist, edges = np.zeros(hist_bins, int), np.arange(hist_bins + 1)
        return {
            "requests_total": self.requests_total,
            "completed": len(self.completed),
            "lost": self.lost,
            "restarted": self.restarted,
            "tokens_generated": self.tokens_generated,
            "throughput_tokens_per_round": self.tokens_per_round,
            "tokens_per_second": self.tokens_generated
            / max(self.wall_seconds, 1e-9),
            "latency_mean": float(lat.mean()) if lat.size else None,
            "latency_p50": self.percentile(50),
            "latency_p95": self.percentile(95),
            "latency_p99": self.percentile(99),
            "latency_hist": {"counts": [int(c) for c in hist],
                             "edges": [float(e) for e in edges]},
            "ttft_mean": float(self.ttft.mean()) if self.ttft.size
            else None,
            "ttft_p50": self.ttft_percentile(50),
            "ttft_p95": self.ttft_percentile(95),
            "ttft_p99": self.ttft_percentile(99),
            "ttft_wait_mean": float(self.ttft_wait.mean())
            if self.ttft_wait.size else None,
            "ttft_decode_mean": float(self.ttft_decode.mean())
            if self.ttft_decode.size else None,
            "stall_skips": self.stall_skips,
            "rounds": self.rounds,
            "drain_rounds": self.drain_rounds,
            "consensus_final": float(self.consensus[-1])
            if self.consensus.size else 0.0,
        }


class GossipFleet:
    """W model replicas that serve a shared request trace while gossiping,
    on the parameters' device.

    world — a ``World`` with ``serve=ServeLoad(...)``; its topology size is
      the fleet width W.  Channel / defense / algorithm / fault axes all
      apply.
    drift — "perturb" (Gaussian random walk, scale ``drift_scale`` per
      round), "none" (frozen params), or pass ``grad_fn`` (the port's
      batched pytree ``Simulator`` signature) for online fine-tuning ticks
      at learning rate ``drift_scale``.
    stall_per_event — decode rounds of debt one gossip event costs its
      replica (communication steals compute); debt >= 1 skips that
      replica's next decode step.  0 = free communication.
    decode_step_fn — share one ``make_fleet_step`` across fleets.
    """

    def __init__(self, model: Model, params: dict, world: World, *,
                 max_batch: int = 4, max_len: int = 64,
                 drift: str = "perturb", drift_scale: float = 0.01,
                 grad_fn: Callable | None = None,
                 stall_per_event: float = 0.0,
                 accelerated: bool | None = None,
                 robust_clip: float | None = None,
                 robust_rule: str = "trim",
                 decode_step_fn: Callable | None = None):
        if world.serve is None:
            raise ValueError("GossipFleet needs a World with serve="
                             "ServeLoad(...) — the arrival trace axis")
        _, hi_p = world.serve.prompt_len
        _, hi_g = world.serve.gen_len
        if max_len < hi_p + hi_g + 1:
            raise ValueError(
                f"max_len={max_len} cannot hold a worst-case request "
                f"(prompt {hi_p} + gen {hi_g}); raise max_len or shrink "
                "the ServeLoad ranges")
        self.model = model
        self.world = world
        self.n = world.n
        self.max_batch = max_batch
        self.max_len = max_len
        self.stall_per_event = float(stall_per_event)
        self.device = tree_leaves(params)[0].device

        stacked = tree_map(
            lambda a: a.unsqueeze(0).expand((self.n,) + a.shape), params)
        self.layout = FlatLayout.from_pytree(stacked, stacked=True)
        # a fresh buffer that nothing writes: the run's carry starts from
        # it and x~ from a clone
        self._bank0 = self.layout.pack(stacked)
        self._caches0 = model.init_cache(max_batch, max_len,
                                         device=self.device)

        # gossip dynamics come from the fault-free twin: chi of a churned
        # world is only defined per phase, but the fleet's mixing dynamic
        # is a design-time constant of the NOMINAL topology
        nominal = dataclasses.replace(
            world, faults=(),
            workers=dataclasses.replace(world.workers, active=None))
        algo_params = nominal.algorithm_params(accelerated)

        if grad_fn is not None:
            drift_fn = flat_grad_fn(self.layout, grad_fn)
        elif drift == "perturb":
            drift_fn = _perturb_grad
        elif drift == "none":
            drift_fn = _zero_grad
        else:
            raise ValueError(f"drift must be 'perturb'/'none' or pass "
                             f"grad_fn, got {drift!r}")
        gamma = float(drift_scale) if (grad_fn is not None
                                       or drift == "perturb") else 0.0
        self.sim = Simulator(grad_fn=drift_fn, params=algo_params,
                             gamma=gamma, robust_clip=robust_clip,
                             robust_rule=robust_rule, device=self.device)
        self._decode_step = decode_step_fn if decode_step_fn is not None \
            else make_fleet_step(model, self.layout)

    # ----------------------------------------------------------------- run
    def _route(self, scheds: list[SlotScheduler], alive: np.ndarray,
               reqs: list[Request], unrouted: list[Request]) -> None:
        """Assign each request to the least-loaded alive replica (ties to
        the lowest id); park it in ``unrouted`` when nobody is alive."""
        for req in reqs:
            cand = [w for w in range(self.n) if alive[w]]
            if not cand:
                unrouted.append(req)
                continue
            w = min(cand, key=lambda i: (scheds[i].load(), i))
            scheds[w].submit(req)

    def run(self, rounds: int, seed: int = 0,
            max_drain_rounds: int = 2000, tracer=None,
            metrics=None) -> FleetReport:
        """Serve the world's arrival trace for ``rounds`` gossip rounds.

        tracer — optional ``analysis.SpanTracer``: emits ``fleet.round``
          and ``fleet.decode`` spans, queue-depth / slot-occupancy /
          consensus counter tracks, ``churn.kill`` instants, and one
          ``fleet.drain`` span (DESIGN.md §15).
        metrics — optional ``analysis.MetricsRegistry``: request / token /
          restart counters plus TTFT and latency histograms, filled once
          at the end of the run.
        """
        world, model, dev = self.world, self.model, self.device
        sched = world.compile(rounds, seed)
        R = sched.rounds
        trace = world.serve.sample_trace(R, seed)
        vocab = model.cfg.vocab_size
        prng = np.random.default_rng(
            np.random.SeedSequence([int(seed), _PROMPT_TAG]))
        requests = [
            Request(uid=i,
                    prompt=prng.integers(0, vocab, size=int(pl)
                                         ).astype(np.int32),
                    max_new=int(gl), arrive_round=int(ar))
            for i, (ar, pl, gl) in enumerate(zip(
                trace.arrival_round, trace.prompt_len, trace.gen_len))]

        arrays, horizon = self.sim.channel_reference_arrays(sched)
        alive = np.asarray(sched.alive_arr())
        idx = np.arange(self.n)
        events = ((sched.partners != idx[None, None, :])
                  & sched.event_mask[:, :, None]).sum(axis=1)  # (R, n)

        bank = self._bank0
        carry = (bank, bank.clone(),
                 torch.zeros(self.n, dtype=torch.float32, device=dev),
                 ring_init(bank, horizon) if horizon else None,
                 torch.Generator(device=dev).manual_seed(int(seed)))
        round_fn = partial(self.sim._round_channel, horizon)
        caches = tree_map(
            lambda a: a.unsqueeze(0).repeat((self.n,) + (1,) * a.dim()),
            self._caches0)

        scheds = [SlotScheduler(self.max_batch, self.max_len)
                  for _ in range(self.n)]
        unrouted: list[Request] = []
        completed: list[Request] = []
        consensus: list = []
        debt = np.zeros(self.n)
        stall_skips = 0
        cursor = 0
        prev_alive = np.ones(self.n, bool)
        t0 = time.time()

        def decode_round(decode_mask: np.ndarray, r: int):
            nonlocal caches
            toks = np.zeros((self.n, self.max_batch), np.int32)
            pos = np.zeros((self.n, self.max_batch), np.int32)
            act = np.zeros((self.n, self.max_batch), bool)
            for w in range(self.n):
                if not decode_mask[w]:
                    continue
                tw, pw, aw = scheds[w].prepare(r)
                toks[w], pos[w], act[w] = tw, pw, aw
            if not act.any():
                return False
            with (tracer.span("fleet.decode", process="fleet",
                              lane="decode",
                              args={"round": r,
                                    "active_slots": int(act.sum())})
                  if tracer is not None else nullcontext()):
                nxt, caches = self._decode_step(
                    carry[0], caches,
                    torch.from_numpy(toks).to(dev)[:, :, None],
                    torch.from_numpy(pos).to(dev),
                    torch.from_numpy(act).to(dev))
                nxt = nxt.cpu().numpy()
            for w in range(self.n):
                if decode_mask[w]:
                    completed.extend(scheds[w].absorb(nxt[w], r))
            return True

        for r in range(R):
            t_round = tracer.now_us() if tracer is not None else 0.0
            al = alive[r]
            # churn: evict the newly-dead replicas' work to survivors
            evicted: list[Request] = []
            for w in range(self.n):
                if prev_alive[w] and not al[w]:
                    evicted.extend(scheds[w].evict_all())
                    debt[w] = 0.0
                    if tracer is not None:
                        tracer.instant("churn.kill", process="fleet",
                                       lane="churn",
                                       args={"worker": w, "round": r})
            # arrivals of round r, then re-admissions (and anything parked
            # while the whole fleet was down)
            arrivals = []
            while cursor < len(requests) \
                    and requests[cursor].arrive_round <= r:
                arrivals.append(requests[cursor])
                cursor += 1
            parked, unrouted = unrouted, []
            self._route(scheds, al, arrivals + evicted + parked, unrouted)

            # gossip events + drift tick of round r on the flat bank
            carry, mets = round_fn(carry, tuple(a[r] for a in arrays))
            consensus.append(mets["consensus"])

            # decode: alive replicas that aren't paying communication debt
            debt[al] += self.stall_per_event * events[r][al]
            decode_mask = al & (debt < 1.0)
            stalled = al & ~decode_mask
            debt[stalled] -= 1.0
            stall_skips += int(stalled.sum())
            decode_round(decode_mask, r)
            prev_alive = al
            if tracer is not None:
                tracer.complete(
                    "fleet.round", t_round, tracer.now_us() - t_round,
                    process="fleet", lane="rounds",
                    args={"round": r, "alive": int(al.sum()),
                          "stalled": int(stalled.sum())})
                tracer.counter(
                    "fleet.queue",
                    {"queue_depth": sum(len(scheds[w].queue)
                                        for w in range(self.n))
                     + len(unrouted),
                     "slot_occupancy": sum(
                         s.req is not None for w in range(self.n)
                         for s in scheds[w].slots)},
                    process="fleet")
                tracer.counter("fleet.consensus",
                               {"consensus": float(mets["consensus"])},
                               process="fleet")

        # drain: gossip stopped, decode-only rounds until every queue and
        # slot is empty (aliveness frozen at the last scheduled round)
        drain = 0
        al = alive[-1] if R else np.ones(self.n, bool)
        t_drain = tracer.now_us() if tracer is not None else 0.0
        while drain < max_drain_rounds:
            if not unrouted and not any(
                    scheds[w].pending() for w in range(self.n) if al[w]):
                break
            if not al.any():
                break  # nobody alive: parked requests are unrecoverable
            parked, unrouted = unrouted, []
            self._route(scheds, al, parked, unrouted)
            if not decode_round(al, R + drain) and not unrouted:
                break
            drain += 1
        if tracer is not None:
            tracer.complete("fleet.drain", t_drain,
                            tracer.now_us() - t_drain, process="fleet",
                            lane="rounds", args={"drain_rounds": drain})
        # the bank is frozen once gossip stops, so the drain tail of the
        # consensus trace is one value repeated — computed, not assumed
        if drain:
            consensus.extend([consensus_distance(carry[0])] * drain)

        wall = time.time() - t0
        lost = len(requests) - len(completed)
        restarted = sum(q.restarts for q in requests)
        lat = np.asarray([q.done_round - q.arrive_round + 1
                          for q in completed], np.float64)
        ttft = np.asarray([q.first_token_round - q.arrive_round + 1
                           for q in completed], np.float64)
        ttft_wait = np.asarray([q.admit_round - q.arrive_round
                                for q in completed], np.float64)
        ttft_decode = np.asarray([q.first_token_round - q.admit_round + 1
                                  for q in completed], np.float64)
        tokens = sum(len(q.out) for q in completed)
        if metrics is not None:
            metrics.counter("fleet_requests_total",
                            "requests in the arrival trace"
                            ).inc(len(requests))
            metrics.counter("fleet_completed_total",
                            "requests served to completion"
                            ).inc(len(completed))
            metrics.counter("fleet_restarts_total",
                            "churn re-admissions").inc(restarted)
            metrics.counter("fleet_tokens_total",
                            "tokens generated").inc(tokens)
            metrics.counter("fleet_stall_skips_total",
                            "decode rounds skipped to pay comm debt"
                            ).inc(stall_skips)
            metrics.gauge("fleet_drain_rounds",
                          "decode-only rounds after the schedule"
                          ).set(drain)
            h = metrics.histogram(
                "fleet_ttft_rounds", "rounds from arrival to first token",
                buckets=(1, 2, 4, 8, 16, 32, 64))
            for v in ttft:
                h.observe(v)
            h = metrics.histogram(
                "fleet_latency_rounds", "rounds from arrival to last token",
                buckets=(2, 4, 8, 16, 32, 64, 128))
            for v in lat:
                h.observe(v)
        cons = (torch.stack(consensus).cpu().numpy().astype(np.float64)
                if consensus else np.zeros(0, np.float64))
        return FleetReport(
            requests_total=len(requests), completed=completed, lost=lost,
            restarted=restarted, latencies=lat, ttft=ttft,
            ttft_wait=ttft_wait, ttft_decode=ttft_decode,
            consensus=cons, rounds=R, drain_rounds=drain,
            tokens_generated=tokens,
            stall_skips=stall_skips, wall_seconds=wall, final_bank=carry[0])
