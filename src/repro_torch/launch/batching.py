"""Continuous-batching request scheduler for the serving path, ported from
``repro.launch.batching``.

Requests arrive with different prompt lengths and generation budgets; the
scheduler packs up to ``max_batch`` active sequences into one fixed-shape
decode batch (padded slots), admits new requests as slots free up, and
steps them together through ``Model.decode_step`` — each slot at its OWN
position, entered as a (B,) vector (per-slot RoPE, cache row and
visibility mask).  A freshly admitted request streams its prompt while its
neighbours generate, and every slot's ids are the ones sequential
``generate`` gives it alone (tests/test_torch_batching.py pins this).

``Request``, ``_Slot`` and ``SlotScheduler`` are host-only copies of the
JAX package's; the fleet driver (``launch/fleet.py``) runs one scheduler
per replica over one shared step function.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map
from ..models.transformer import Model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                # (P,) int ids (numpy or a tensor; host-indexed)
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # serving-trace bookkeeping (filled by the fleet driver)
    arrive_round: int = 0
    done_round: int = -1
    admit_round: int = -1      # round a slot last accepted this request
    first_token_round: int = -1  # round the first surviving token landed
    restarts: int = 0          # times re-admitted after a churn kill


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0               # tokens fed so far == next cache position
    prompt_cursor: int = 0     # how much of the prompt has been fed
    generated: int = 0


class SlotScheduler:
    """Host-side slot state machine: admission, token staging, absorption.

    Device-free — ``prepare()`` emits plain Python lists the driver turns
    into one fixed-shape batch, ``absorb()`` folds the decoded tokens back.
    Invariants (tests/test_torch_batching.py): every submitted request finishes
    exactly once with exactly ``max_new`` tokens (unless evicted), under
    any interleaving of submissions and steps.
    """

    def __init__(self, max_batch: int, max_len: int):
        self.max_batch = max_batch
        self.max_len = max_len
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []

    # ------------------------------------------------------------ frontend
    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new + 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} needs {need} cache rows but max_len="
                f"{self.max_len} — the slot would silently truncate below "
                "the guaranteed max_new tokens (mirrors the GossipFleet "
                "ServeLoad range check)")
        self.queue.append(req)

    def load(self) -> int:
        """Queued + in-flight requests (the fleet router's balance key)."""
        return len(self.queue) + sum(s.req is not None for s in self.slots)

    def pending(self) -> bool:
        return bool(self.queue) or any(s.req is not None for s in self.slots)

    # ------------------------------------------------------------ stepping
    def _admit(self, round_idx: int = 0) -> None:
        for slot in self.slots:
            if slot.req is None and self.queue:
                slot.req = self.queue.popleft()
                slot.req.admit_round = round_idx
                slot.pos = 0
                slot.prompt_cursor = 0
                slot.generated = 0

    def prepare(self, round_idx: int = 0
                ) -> tuple[list[int], list[int], list[bool]]:
        """Admit waiting requests, then stage one token per active slot.

        Returns (tokens, positions, active) as length-``max_batch`` lists:
        slot i feeds ``tokens[i]`` at cache position ``positions[i]``.
        A slot still streaming its prompt feeds the next prompt token; a
        generating slot feeds its last output token.  ``round_idx`` stamps
        ``admit_round`` on newly-admitted requests (TTFT bookkeeping).
        """
        self._admit(round_idx)
        toks, pos, act = [], [], []
        for s in self.slots:
            r = s.req
            if r is None:
                toks.append(0)
                pos.append(0)
                act.append(False)
                continue
            if s.prompt_cursor < len(r.prompt):
                toks.append(int(r.prompt[s.prompt_cursor]))
            else:
                toks.append(int(r.out[-1]) if r.out else 0)
            pos.append(s.pos)
            act.append(True)
        return toks, pos, act

    def absorb(self, next_tokens: np.ndarray, round_idx: int = 0
               ) -> list[Request]:
        """Fold one decode step's outputs back into the slots; returns the
        requests that completed this step.  The token produced when the
        LAST prompt token is fed is the first generated token — exactly
        ``generate``'s sampling point."""
        done: list[Request] = []
        for i, s in enumerate(self.slots):
            r = s.req
            if r is None:
                continue
            s.pos += 1
            if s.prompt_cursor < len(r.prompt) - 1:
                s.prompt_cursor += 1          # still streaming the prompt
            else:
                if s.prompt_cursor == len(r.prompt) - 1:
                    s.prompt_cursor += 1      # prompt consumed this step
                r.out.append(int(next_tokens[i]))
                if len(r.out) == 1:
                    r.first_token_round = round_idx
                s.generated += 1
            if s.generated >= r.max_new or s.pos >= self.max_len - 1:
                r.done = True
                r.done_round = round_idx
                self.finished.append(r)
                done.append(r)
                s.req = None
        return done

    # --------------------------------------------------------------- churn
    def evict_all(self) -> list[Request]:
        """Kill this replica: return every queued AND in-flight request for
        re-admission elsewhere.  In-flight requests restart from scratch
        (their cache rows die with the replica): outputs are cleared and
        ``restarts`` is bumped — degradation, not loss."""
        out: list[Request] = []
        for s in self.slots:
            if s.req is not None:
                s.req.out = []
                s.req.restarts += 1
                # TTFT restarts with the request: the first token died
                # with the replica's KV rows
                s.req.admit_round = -1
                s.req.first_token_round = -1
                out.append(s.req)
                s.req = None
        out.extend(self.queue)
        self.queue.clear()
        return out


def gate_caches(active: torch.Tensor, old: list, new: list) -> list:
    """Keep inactive slots' cache state untouched after a decode step.

    ``decode_step`` writes every slot's cache, so a slot fed padding (token
    0 at position 0) would overwrite cache row 0, exactly where an
    in-flight request's first K/V row lives.  The fleet driver feeds WHOLE
    replicas as padding while they stall on communication debt, so this
    gating is load-bearing.  Cache leaves are (repeat, B, ...): batch is
    axis 1.  A select, not arithmetic: the kept rows are bit for bit the
    old ones."""
    def sel(o, n):
        return torch.where(active.reshape((1, -1) + (1,) * (n.dim() - 2)),
                           n, o)

    return tree_map(sel, old, new)


def make_batched_step(model: Model) -> Callable:
    """One greedy decode step over a slot batch:

    (params, caches, tokens (B, 1) int, positions (B,) int32, active (B,)
    bool) -> (next ids (B,) int32, 0 where inactive; new caches, gated).
    """
    vocab = model.cfg.vocab_size

    def step(params, caches, tokens, positions, active):
        with torch.no_grad():
            logits, new_caches = model.decode_step(params, tokens,
                                                   positions, caches)
            nxt = logits[:, 0, :vocab].argmax(dim=-1)
            return (torch.where(active, nxt, 0).to(torch.int32),
                    gate_caches(active, caches, new_caches))

    return step


class ContinuousBatcher:
    """Slot-based continuous batching over the decode path (one replica),
    on the parameters' device.  ``step_fn`` lets callers share one step
    function across batchers."""

    def __init__(self, model: Model, params: dict, max_batch: int = 4,
                 max_len: int = 512, step_fn: Callable | None = None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = tree_leaves(params)[0].device
        self.caches = model.init_cache(max_batch, max_len,
                                       device=self.device)
        self.scheduler = SlotScheduler(max_batch, max_len)
        self._step = step_fn if step_fn is not None \
            else make_batched_step(model)

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    @property
    def finished(self) -> list[Request]:
        return self.scheduler.finished

    def step(self) -> int:
        """Advance every active slot by one token; returns #active slots."""
        toks, pos, act = self.scheduler.prepare()
        n_active = sum(act)
        if not n_active:
            return 0
        dev = self.device
        nxt, self.caches = self._step(
            self.params, self.caches,
            torch.tensor(toks, dtype=torch.int32, device=dev)[:, None],
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(act, dtype=torch.bool, device=dev))
        self.scheduler.absorb(nxt.cpu().numpy())
        return n_active

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.scheduler.queue:
                break
        return self.scheduler.finished
