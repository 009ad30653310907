"""Dry run on the meta device, ported from ``repro.launch.dryrun``: every
(arch x shape) step on a production mesh, traced on meta tensors under
the op counter, with its per-device memory, cost and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh gossip

The JAX package compiles each step for 512 faked host devices; here the
step runs once on the meta device (``LoweredSpec.trace``): it needs no
card and no devices, computes nothing and allocates nothing.  A report
holds, per device of the mesh:

  * argument bytes — exact, from the partition specs: each leaf's bytes
    divided by the sizes of the mesh axes that shard it;
  * FLOPs and bytes written (``hlo_flops_per_device``,
    ``hlo_bytes_per_device``) — the counted global program divided by the
    devices, i.e. an even split;
  * peak memory — the argument bytes plus the peak of the storages the
    step makes when traced at one device's batch slice (the batch divided
    by the mesh axes of the "batch" rule where they divide it; the gossip
    step's traced peak is split evenly instead).  That
    trace runs the whole model at full width, so activations split by
    tensor parallelism, and a train step's gradients and updated state,
    count whole: an upper bound wherever the model axis splits them;
  * collective bytes — from an analytic model over the specs, since one
    process on the meta device issues no collective.  Per step and
    device: an all-gather of every FSDP-sharded parameter per forward (a
    remat recompute is one more forward), its result the leaf's shard
    times the FSDP axis size; a reduce-scatter of each such gradient per
    backward, its result the shard; two all-reduces of a block's
    activations (tokens per device x d_model x the compute dtype's bytes)
    per forward and per backward in every block, where the model axis is
    larger than 1.  The gossip step adds one collective-permute of the
    worker's parameter shard per gossip event, or one all-reduce of it
    over the worker axis (AR-SGD).  Data-parallel all-reduces of
    replicated leaves and MoE all-to-alls are not in the model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback

import torch
from torch.func import grad_and_value

from ..analysis.op_cost import count
from ..analysis.roofline import HBM_BYTES, model_flops, roofline_terms
from ..configs import ARCHITECTURES, get_config
from ..core.a2cid2 import params_from_graph
from ..core.graphs import ring_graph
from ..core.tree import tree_flatten, tree_flatten_with_path
from ..models.layers import dtype_of
from ..models.transformer import Model
from ..optim import sgd
from ..shapes import META, SHAPES, adapt_config, shape_for
from ..sharding import PartitionSpec as P
from . import shardings as S
from .gossip_train import StackedGossipTrainer
from .mesh import (make_gossip_mesh, make_production_mesh, mesh_devices,
                   rules_for)
from .steps import abstract_params, bundle_for

def _mesh(name: str):
    if name == "single":
        return make_production_mesh(multi_pod=False)
    if name == "multi":
        return make_production_mesh(multi_pod=True)
    if name == "gossip":
        return make_gossip_mesh()
    raise ValueError(name)


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    return math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple)
                                             else (ax,)))


def local_batch(rows: int, mesh, rules: dict) -> int:
    """The batch split factor of ``rows`` batch rows: the size of the "batch"
    rule's mesh axes where it divides them (as ``shardings._fit`` splits
    them), else 1."""
    n = _axes_size(mesh, rules.get("batch"))
    return n if rows % n == 0 else 1


def collective_model(params, params_sh, mesh, rules: dict, cfg,
                     tokens: int, *, forwards: int, backwards: int) -> dict:
    """Per-device collective bytes of one step by kind (the module
    docstring's model): ``tokens`` a forward's tokens on one device,
    ``forwards`` / ``backwards`` the passes the step runs."""
    fsdp = rules.get("fsdp")
    n_fsdp = _axes_size(mesh, fsdp)
    fsdp_axes = set(fsdp if isinstance(fsdp, tuple) else (fsdp,))
    gather = scatter = 0
    leaves, treedef = tree_flatten(params)
    for leaf, spec in zip(leaves, treedef.flatten_up_to(params_sh)):
        axes = {a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))}
        if fsdp is None or n_fsdp == 1 or not axes & fsdp_axes:
            continue
        shard = S.shard_bytes(leaf, spec, mesh)
        gather += forwards * shard * n_fsdp
        scatter += backwards * shard
    out = {"all-gather": float(gather), "reduce-scatter": float(scatter)}
    if _axes_size(mesh, rules.get("tp")) > 1:
        act = tokens * cfg.d_model * dtype_of(cfg.compute_dtype).itemsize
        out["all-reduce"] = float(2 * (forwards + backwards)
                                  * cfg.num_layers * act)
    return {k: v for k, v in out.items() if v}


def run_one(arch: str, shape_name: str, mesh_name: str,
            serve_param_mode: str = "fsdp",
            train_microbatches: int = 4,
            carry_shard: str = None) -> dict:
    t0 = time.time()
    mesh = _mesh(mesh_name)
    rules = rules_for(mesh)
    chips = mesh_devices(mesh)

    cfg = get_config(arch).with_updates(param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    if carry_shard:
        cfg = cfg.with_updates(carry_shard=carry_shard)
    shape = shape_for(shape_name)
    spec = bundle_for(cfg, shape, mesh, rules,
                      train_microbatches=train_microbatches,
                      serve_param_mode=serve_param_mode)
    arg_bytes = spec.arg_bytes(mesh)
    t_lower = time.time() - t0
    cost = spec.trace(mesh)
    m = train_microbatches if shape.kind == "train" else 1
    split = local_batch(shape.global_batch // m, mesh, rules)
    local = dataclasses.replace(shape,
                                global_batch=shape.global_batch // split)
    act_peak = (cost.peak_live_bytes if split == 1 else bundle_for(
        cfg, local, mesh, rules, train_microbatches=train_microbatches,
        serve_param_mode=serve_param_mode).trace().peak_live_bytes)
    t_compile = time.time() - t0 - t_lower

    acfg = adapt_config(cfg, shape)
    pcounts = _param_counts(Model(acfg))
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    kind = "train" if shape.kind == "train" else "serve"
    mf = model_flops(pcounts["total"], pcounts["active"], tokens, kind)

    params, params_sh = ((spec.args[0].params, spec.arg_shardings[0].params)
                         if shape.kind == "train"
                         else (spec.args[0], spec.arg_shardings[0]))
    # a train step runs each micro-batch forward twice (remat), backward once
    fwd, bwd = (2 * m, m) if shape.kind == "train" else (1, 0)
    seq = shape.seq_len if shape.kind in ("train", "prefill") else 1
    detail = collective_model(params, params_sh, mesh, rules, acfg,
                              local.global_batch // m * seq,
                              forwards=fwd, backwards=bwd)
    peak = arg_bytes + act_peak
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        cost={"flops": cost.flops, "bytes accessed": cost.write_bytes},
        model_flops_total=mf, peak_memory=float(peak),
        collective_detail=detail)
    out = report.to_dict()
    out.update({
        "ok": True,
        "fits_h100_hbm": bool(peak <= HBM_BYTES),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "param_count": pcounts["total"], "active_params": pcounts["active"],
        # no XLA here: the op counter's own FLOPs per device
        "xla_cost_analysis_flops": float(cost.flops),
        "memory_analysis": (f"argument_bytes={arg_bytes} "
                            f"activation_peak_bytes={act_peak} at batch "
                            f"{local.global_batch} of {shape.global_batch}"
                            f" (meta trace)"),
    })
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
          f"(build {t_lower:.1f}s, trace {t_compile:.1f}s, "
          f"peak/device {peak/1e9:.2f} GB, bottleneck {out['bottleneck']})")
    print(f"  memory: {out['memory_analysis']}")
    print(f"  cost: flops/device={out['hlo_flops_per_device']:.3e} "
          f"bytes/device={out['hlo_bytes_per_device']:.3e} "
          f"collective/device={out['collective_bytes_per_device']:.3e}")
    return out


def _param_counts(model) -> dict:
    """Total and *active* (per-token) parameter counts, analytic."""
    cfg = model.cfg
    flat, _ = tree_flatten_with_path(abstract_params(model))
    total = sum(leaf.numel() for _, leaf in flat)
    active = total
    if cfg.moe is not None:
        # routed experts contribute top_k/num_experts of their weights
        routed = sum(leaf.numel() for p, leaf in flat
                     if "moe_" in S._path_str(p) and leaf.dim() >= 3)
        active = total - routed + int(routed * cfg.moe.top_k
                                      / cfg.moe.num_experts)
    return {"total": total, "active": active}


def run_gossip_step(arch: str = "qwen3-0.6b", n_workers: int = 8,
                    accelerated: bool = True, mode: str = "gossip",
                    comms_per_step: int = 1) -> dict:
    """The decentralized A2CiD2 train step on the gossip mesh (8 workers x
    8 data x 8 model = 512 devices, ring graph): ``StackedGossipTrainer``
    with ``sgd()``, every state leaf with a leading worker axis sharded over
    "worker", traced on the meta device (the plain versions of the gossip
    kernels run there).

    The per-worker gradient is ``torch.func.grad_and_value`` of the loss
    without remat (``torch.utils.checkpoint`` needs saved-tensor hooks,
    which ``torch.func`` transforms refuse), where the JAX step remats.
    Peak per device: the argument bytes plus the traced step's peak split
    evenly over the devices that split its batch (the workers, and the
    worker's batch over "data"): one trace, where ``run_one`` traces a
    second time at one device's batch slice."""
    t0 = time.time()
    mesh = make_gossip_mesh(n_workers=n_workers)
    rules = rules_for(mesh)
    cfg = get_config(arch).with_updates(param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    model = Model(cfg)
    graph = ring_graph(n_workers)
    acid = params_from_graph(graph, accelerated=accelerated)

    def grad_fn(params, batch):
        grads, (loss, metrics) = grad_and_value(
            lambda p: model.loss(p, batch), has_aux=True)(params)
        return (loss, metrics), grads

    trainer = StackedGossipTrainer(
        grad_fn, sgd(), graph, acid, lr=0.1,
        comms_per_step=(0 if mode == "grad_only" else comms_per_step))
    step = {"ar": trainer.make_ar_step,
            "pair_ring": trainer.make_pair_ring_step}.get(
        mode, trainer.make_step)()

    state = trainer.init(abstract_params(model), torch.Generator())
    b, sq = 256 // n_workers, 4096  # per-worker slice of train_4k

    batch = {k: torch.empty((n_workers, b, sq), dtype=torch.int32,
                            device=META) for k in ("inputs", "labels")}
    psh = S.stacked_param_shardings(state.x, mesh, rules)
    x_bytes = S.per_device_bytes(state.x, psh, mesh)
    arg_bytes = (2 * x_bytes + S.per_device_bytes(state.opt.mu, psh, mesh)
                 + S.shard_bytes(state.opt.step, P("worker"), mesh)
                 + S.per_device_bytes(batch, {k: P("worker", "data", None)
                                              for k in batch}, mesh))
    _, cost = count(step, state, batch)
    split = local_batch(b, mesh, rules)
    act_peak = cost.peak_live_bytes / (n_workers * split)
    chips = mesh_devices(mesh)
    peak = arg_bytes + act_peak

    detail = collective_model(state.x, psh, mesh, rules, cfg,
                              b // split * sq, forwards=1, backwards=1)
    events = 0 if mode in ("grad_only", "ar") else comms_per_step
    if events:
        detail["collective-permute"] = float(events * x_bytes)
    if mode == "ar":
        detail["all-reduce"] = detail.get("all-reduce", 0.0) + x_bytes
    out = {
        "ok": True, "arch": arch, "shape": "train_4k", "mesh": "gossip",
        "accelerated": accelerated,
        "n_workers": n_workers, "chips": chips,
        "peak_memory_per_device": float(peak),
        "fits_h100_hbm": bool(peak <= HBM_BYTES),
        "hlo_flops_per_device": cost.flops / chips,
        "hlo_bytes_per_device": cost.write_bytes / chips,
        "collective_bytes_per_device": float(sum(detail.values())),
        "collective_detail": detail,
        "compile_s": round(time.time() - t0, 1),
        "memory_analysis": (f"argument_bytes={arg_bytes} "
                            f"activation_peak_bytes={act_peak} (the meta "
                            f"trace's over {n_workers * split} devices)"),
    }
    out["mode"] = mode
    out["comms_per_step"] = comms_per_step
    tag = mode if mode != "gossip" else ("A2CiD2" if accelerated
                                         else "baseline")
    print(f"[dryrun] gossip({tag}) {arch} x train_4k x "
          f"({n_workers},8,8): OK (total {out['compile_s']}s, peak/device "
          f"{peak/1e9:.2f} GB, collective/device "
          f"{out['collective_bytes_per_device']/1e9:.1f} GB)")
    return out


GOSSIP_RUNS = (dict(accelerated=True), dict(accelerated=False),
               dict(mode="grad_only"), dict(mode="ar"),
               dict(accelerated=True, comms_per_step=2),
               dict(mode="pair_ring"))


def _record(results: list, out: str | None, label: dict, run) -> None:
    """Append ``run()``'s report; a failure is recorded (``label`` with
    ``ok`` false and the error) and the run goes on."""
    try:
        results.append(run())
    except Exception as e:  # noqa: BLE001 — record and continue
        traceback.print_exc()
        results.append({**label, "ok": False,
                        "error": f"{type(e).__name__}: {e}"})
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=("single", "multi", "gossip"))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on --mesh")
    ap.add_argument("--out", type=str, default=None,
                    help="write the JSON results to this file")
    ap.add_argument("--serve-param-mode", default="fsdp",
                    choices=("fsdp", "tp_only"))
    ap.add_argument("--train-microbatches", type=int, default=4)
    ap.add_argument("--carry-shard", default=None,
                    choices=(None, "embed", "seq", "none"))
    args = ap.parse_args(argv)

    results: list = []
    if args.mesh == "gossip":
        arch = args.arch or "qwen3-0.6b"
        for kw in GOSSIP_RUNS:
            _record(results, args.out,
                    {"arch": arch, "mesh": "gossip", **kw},
                    lambda kw=kw: run_gossip_step(arch, **kw))
    else:
        combos = ([(args.arch, args.shape)] if not args.all else
                  [(a, s) for a in ARCHITECTURES for s in SHAPES])
        for arch, shape in combos:
            _record(results, args.out,
                    {"arch": arch, "shape": shape, "mesh": args.mesh},
                    lambda arch=arch, shape=shape: run_one(
                        arch, shape, args.mesh,
                        serve_param_mode=args.serve_param_mode,
                        train_microbatches=args.train_microbatches,
                        carry_shard=args.carry_shard))
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} combos OK")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
