"""The op-level cost counter: the port's counterpart of
``repro.analysis.hlo_cost``.

The JAX package parses compiled HLO text because XLA's ``cost_analysis``
counts a ``while`` body once, whatever its trip count.  Eager PyTorch has
no loop to undercount: every Python iteration dispatches its ops again
(``Model.prefill``'s loop of decode steps, micro-batches, layers), so a
dispatch mode that sees every aten op gets trip counts for free.
:class:`OpCounter` is that mode.  It yields an :class:`OpCost`:

  * ``flops`` — every matmul-like aten op (mm, addmm, bmm, baddbmm, the
    convolutions, the fused attention ops), by the formulas of
    ``torch.utils.flop_counter``: 2 x the output elements x the contracted
    size.  A recomputed forward under ``torch.utils.checkpoint`` counts
    again, as XLA's remat does;
  * ``write_bytes`` — the result bytes of every aten op that writes: an
    op whose result has a fresh storage, or an in-place / ``out=`` op (its
    output counts).  Views, reshapes that alias their input and bare
    allocations (``empty*``) write nothing.  The eager counterpart of "the
    result bytes of top-level ops"; the one deliberate difference from
    JAX's count is the KV cache, which the port writes with a whole-cache
    select (``models/attention._update_slot``): it is counted as written,
    where JAX counts a ``dynamic-update-slice`` as the update's bytes;
  * ``collective_bytes`` / ``collective_detail`` — the result bytes of
    every ``_c10d_functional`` collective, by JAX's kind names (0 for a
    one-process program);
  * ``peak_live_bytes`` — the peak of the bytes of the storages made
    inside the counter and still alive, each freed when its storage dies
    (the counterpart of ``memory_analysis``'s temporaries and outputs;
    the arguments, made before, are not in it).

A hand kernel bound through ``ctypes`` is invisible to the dispatch mode,
so its wrapper reports its work with :func:`record` (what its plain
version's aten ops would count as FLOPs, and the kernel's minimum bytes);
the same step then reads the same FLOPs on the card as on the meta device,
where the plain versions run.  Works on any device, the meta device
included (shapes only, nothing computed).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the functional collectives, by the kind names of JAX's HLO count
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_aten = torch.ops.aten
# allocations that write nothing
_NO_WRITE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided}


@dataclasses.dataclass(frozen=True)
class OpCost:
    flops: float
    write_bytes: float
    collective_bytes: float
    collective_detail: dict
    peak_live_bytes: float
    # kernel name -> {"calls", "flops", "bytes"} reported through record()
    recorded: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: ...`` then ``c.cost()``.  Counters nest:
    each active one sees every op and every ``record``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.write_bytes = 0.0
        self.collective_detail: dict = {}
        self.recorded: dict = {}
        self._live: dict = {}       # id(storage) -> bytes
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, storage) -> None:
        key = id(storage)
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flop_fn = flop_registry.get(packet)
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not func.is_view:
            writes = packet not in _NO_WRITE
            mutable = func._schema.is_mutable
            ins = {id(t.untyped_storage())
                   for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            for t in outs:
                st = t.untyped_storage()
                fresh = id(st) not in ins
                if writes and (fresh or mutable):
                    self.write_bytes += _nbytes(t)
                if fresh and id(st) not in self._live:
                    self._track(st)
        kind = (_COLLECTIVES.get(packet.__name__)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            self.collective_detail[kind] = (
                self.collective_detail.get(kind, 0.0)
                + sum(_nbytes(t) for t in outs))
        return out

    def _record(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.write_bytes += nbytes
        row = self.recorded.setdefault(name, {"calls": 0, "flops": 0.0,
                                              "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def cost(self) -> OpCost:
        return OpCost(self.flops, self.write_bytes,
                      float(sum(self.collective_detail.values())),
                      dict(self.collective_detail),
                      float(self.peak_live_bytes),
                      {k: dict(v) for k, v in self.recorded.items()})


def counting() -> bool:
    """True while an :class:`OpCounter` is active."""
    return any(isinstance(m, OpCounter)
               for m in _get_current_dispatch_mode_stack())


def record(name: str, flops: float, nbytes: float) -> None:
    """Add a hand kernel's work to every active :class:`OpCounter` (a
    no-op with none): ``flops`` as its plain version's aten ops would count
    them, ``nbytes`` the bytes it must move (inputs read once, outputs
    written once)."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpCounter):
            mode._record(name, flops, nbytes)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)`` of one call."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost()
