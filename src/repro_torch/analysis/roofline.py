"""Roofline terms of a dry-run step, ported from ``repro.analysis.roofline``
with the peaks of one NVIDIA H100.

    compute term    = FLOPs per device / PEAK_FLOPS_BF16
    memory term     = bytes per device / HBM_BW
    collective term = collective bytes per device / LINK_BW

The FLOPs and bytes come from the op counter (``analysis.op_cost``), the
collective bytes from the dry run's analytic model (``launch.dryrun``);
the JAX package parses both out of compiled HLO text.

The peaks are NVIDIA's data sheet for the H100 SXM5 80GB (dense rates,
without sparsity, at its 700 W power limit); a card set to a lower limit
runs slower under load, so every time measured against them is reported
with the card's name and power limit.  This module is the one place the
port states them: ``chip_smoke.py`` imports them from here.
"""
from __future__ import annotations

import dataclasses

DEVICE = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 / fp16 on the tensor cores
PEAK_FLOPS_TF32 = 494.7e12    # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 on the CUDA cores
HBM_BW = 3.35e12              # B/s, HBM3
LINK_BW = 450e9               # B/s per direction, NVLink 4 (18 links)
HBM_BYTES = 80e9              # device memory


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) with N = active params for MoE; decode
    steps use 2*N_active per token (forward only)."""
    n = active_param_count or param_count
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per-device FLOPs (op counter)
    hlo_bytes: float          # per-device bytes written (op counter)
    collective_bytes: float   # per-device collective bytes (sum over kinds)
    collective_detail: dict
    model_flops_total: float  # analytic 6ND (global)
    peak_memory_per_device: float

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs * chips) — remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops_total / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops,
            "hlo_bytes_per_device": self.hlo_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_detail": self.collective_detail,
            "model_flops_total": self.model_flops_total,
            "peak_memory_per_device": self.peak_memory_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: dict, model_flops_total: float, peak_memory: float,
                   collective_detail: dict | None = None) -> RooflineReport:
    """``cost`` holds "flops" and "bytes accessed" per device (the JAX
    function's keys); ``collective_detail`` the per-device collective bytes
    by kind (the JAX function parses them from HLO text instead)."""
    detail = dict(collective_detail or {})
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        collective_bytes=float(sum(detail.values())),
        collective_detail=detail,
        model_flops_total=model_flops_total,
        peak_memory_per_device=peak_memory,
    )
