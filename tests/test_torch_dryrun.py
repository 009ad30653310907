"""The dry run on the meta device (``repro_torch.launch.dryrun``).

``run_one`` on two architectures (reduced widths: the full sizes run
through the CLI, ``python -m repro_torch.launch.dryrun --all``) x the four
shapes on the single- and multi-pod meshes, ``run_gossip_step`` in two
modes and the CLI's ``--out`` JSON: every report has the JAX dry run's
keys (``fits_h100_hbm`` for ``fits_v5e_hbm``) and numbers that add up
(FLOPs per device x devices = the counted program; peak = argument bytes +
the traced activation peak).  ``model_flops`` and ``RooflineReport``
against JAX's on fixed numbers (the time terms at the H100's peaks), and
the per-device argument bytes of full-size steps against the sum over
leaves of JAX's own ``bundle_for`` specs.
"""
import json
import math

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.analysis import roofline as jroof
from repro.configs import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.shapes import shape_for as jshape_for
from repro_torch.analysis import roofline
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import rules_for
from repro_torch.shapes import SHAPES, shape_for

ROOF_KEYS = set(jroof.RooflineReport("a", "s", "m", 1, 1.0, 1.0, 1.0, {},
                                     1.0, 1.0).to_dict())
RUN_KEYS = ROOF_KEYS | {"ok", "fits_h100_hbm", "lower_s", "compile_s",
                        "param_count", "active_params",
                        "xla_cost_analysis_flops", "memory_analysis"}
GOSSIP_KEYS = {"ok", "arch", "shape", "mesh", "accelerated", "n_workers",
               "chips", "peak_memory_per_device", "fits_h100_hbm",
               "hlo_flops_per_device", "hlo_bytes_per_device",
               "collective_bytes_per_device", "collective_detail",
               "compile_s", "memory_analysis", "mode", "comms_per_step"}


@pytest.fixture
def reduced(monkeypatch):
    """The dry run's configs at reduced widths (2 layers, d_model <= 512)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name, reduced=True))


def _bf16(name):
    return get_config(name, reduced=True).with_updates(
        param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_run_one_every_shape(reduced, arch):
    for shape in SHAPES:
        cost = None
        for mesh_name in ("single", "multi"):
            mesh = dryrun._mesh(mesh_name)
            out = dryrun.run_one(arch, shape, mesh_name)
            assert set(out) == RUN_KEYS
            assert out["ok"] and out["mesh"] == mesh_name
            assert out["chips"] == math.prod(mesh.shape.values())
            spec = steps.bundle_for(_bf16(arch), shape_for(shape), mesh,
                                    rules_for(mesh))
            cost = cost or spec.trace()
            assert out["hlo_flops_per_device"] * out["chips"] == \
                pytest.approx(cost.flops, rel=1e-12)
            # the first trace also writes RoPE's frequencies into their
            # per-device cache (attention._inv_freqs_on): a few hundred bytes
            assert out["hlo_bytes_per_device"] * out["chips"] == \
                pytest.approx(cost.write_bytes, rel=1e-9)
            assert out["peak_memory_per_device"] > spec.arg_bytes(mesh)
            assert out["fits_h100_hbm"] == (out["peak_memory_per_device"]
                                            <= roofline.HBM_BYTES)
            assert out["collective_bytes_per_device"] == pytest.approx(
                sum(out["collective_detail"].values()))
            assert set(out["collective_detail"]) <= {
                "all-gather", "reduce-scatter", "all-reduce"}
            assert ("reduce-scatter" in out["collective_detail"]) == (
                shape == "train_4k")
            assert out["param_count"] == dryrun._param_counts(
                steps.Model(_bf16(arch)))["total"]
            assert out["useful_flops_ratio"] > 0
            json.dumps(out)


def test_run_gossip_step_two_modes(reduced):
    a2 = dryrun.run_gossip_step("qwen3-0.6b", accelerated=True)
    ar = dryrun.run_gossip_step("qwen3-0.6b", mode="ar")
    for out in (a2, ar):
        assert set(out) == GOSSIP_KEYS
        assert out["ok"] and out["chips"] == 512 and out["mesh"] == "gossip"
        assert out["hlo_flops_per_device"] > 0
        assert out["collective_bytes_per_device"] == pytest.approx(
            sum(out["collective_detail"].values()))
    assert "collective-permute" in a2["collective_detail"]
    assert "collective-permute" not in ar["collective_detail"]
    # AR-SGD adds one all-reduce of the parameter shard
    assert ar["collective_detail"]["all-reduce"] > \
        a2["collective_detail"]["all-reduce"]


def test_cli_out_json_and_failure_exit(reduced, tmp_path, capsys):
    path = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--serve-param-mode", "tp_only", "--out", str(path)])
    (report,) = json.loads(path.read_text())
    assert report["ok"] and set(report) == RUN_KEYS
    assert report["shape"] == "decode_32k" and report["mesh"] == "single"
    # tp_only: no FSDP gathers of the weights
    assert "all-gather" not in report["collective_detail"]
    assert "1/1 combos OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--out", str(path)])
    assert exc.value.code == 1
    (failed,) = json.loads(path.read_text())
    assert failed["ok"] is False and failed["arch"] == "no-such-arch"


def test_model_flops_and_report_against_jax():
    for args in ((1000, 0, 4096, "train"), (1000, 250, 4096, "train"),
                 (1000, 250, 7, "serve")):
        assert roofline.model_flops(*args) == jroof.model_flops(*args)
    kw = dict(arch="a", shape="s", mesh="m", chips=256, hlo_flops=3.0e15,
              hlo_bytes=2.0e12, collective_bytes=4.0e10,
              collective_detail={"all-gather": 4.0e10},
              model_flops_total=5.0e17, peak_memory_per_device=7.0e10)
    port, ref = roofline.RooflineReport(**kw), jroof.RooflineReport(**kw)
    got, want = port.to_dict(), ref.to_dict()
    assert set(got) == set(want)
    for k in ("arch", "shape", "mesh", "chips", "hlo_flops_per_device",
              "hlo_bytes_per_device", "collective_bytes_per_device",
              "collective_detail", "model_flops_total",
              "peak_memory_per_device", "useful_flops_ratio"):
        assert got[k] == want[k], k
    # the same terms at the H100's peaks in place of the TPU's
    assert port.compute_s == pytest.approx(
        ref.compute_s * jroof.PEAK_FLOPS_BF16 / roofline.PEAK_FLOPS_BF16,
        rel=1e-15)
    assert port.memory_s == pytest.approx(
        ref.memory_s * jroof.HBM_BW / roofline.HBM_BW, rel=1e-15)
    assert port.collective_s == pytest.approx(
        ref.collective_s * jroof.ICI_BW / roofline.LINK_BW, rel=1e-15)
    assert port.bottleneck == max(
        ("compute", "memory", "collective"),
        key=lambda t: got[f"{t}_s"])
    rep = roofline.roofline_terms(
        arch="a", shape="s", mesh_name="m", chips=2,
        cost={"flops": 1.0, "bytes accessed": 2.0}, model_flops_total=3.0,
        peak_memory=4.0, collective_detail={"all-reduce": 5.0,
                                            "all-gather": 1.0})
    assert (rep.hlo_flops, rep.hlo_bytes, rep.collective_bytes) == \
        (1.0, 2.0, 6.0)


def _jax_arg_bytes(spec, mesh) -> int:
    """Sum over leaves of JAX's own specs: each leaf's bytes over the sizes
    of the mesh axes its ``PartitionSpec`` names."""
    total = 0
    for leaf, sh in zip(jax.tree.leaves(spec.args),
                        jax.tree.leaves(spec.arg_shardings)):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for ax in sh.spec:
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n //= mesh.shape[a]
        total += n
    return total


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "mamba2-780m"])
def test_arg_bytes_equal_jax_specs(arch, mesh_name):
    mesh = dryrun._mesh(mesh_name)
    jm = AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
    cfg = get_config(arch).with_updates(param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    jcfg = jax_config(arch).with_updates(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    for shape in SHAPES:
        for mode in ("fsdp", "tp_only"):
            if mode == "tp_only" and shape == "train_4k":
                continue
            jspec = jsteps.bundle_for(jcfg, jshape_for(shape), jm,
                                      jmesh.rules_for(jm),
                                      serve_param_mode=mode)
            spec = steps.bundle_for(cfg, shape_for(shape), mesh,
                                    rules_for(mesh), serve_param_mode=mode)
            assert spec.arg_bytes(mesh) == _jax_arg_bytes(jspec, jm), \
                (shape, mode)
            assert spec.donate == jspec.donate
