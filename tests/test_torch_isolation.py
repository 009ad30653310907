"""The port stands alone: importing every module of ``repro_torch`` with JAX,
networkx and msgpack blocked loads nothing of the JAX package (a matching
bank builds and a ``GossipTrainer`` step runs there, a ``World`` and a
``WorldSweep`` build and compile there, a reduced transformer builds and
runs its forward on both attention paths, a telemetry replay runs through
``run_world``, and a ``make_train_step`` step and a checkpoint round trip
run there, and the serving path runs there: ``generate`` on a reduced
Qwen3, a ``ContinuousBatcher`` drained, a 3-replica ``train_bench`` fleet
for 4 rounds, and a 2-shard sharded replay on CPU shards, bit for bit the
single-device one), and the entry points refuse to run on a machine
without a card unless the caller names the CPU.  The rest of the model zoo
runs there too: reduced DeepSeek-V3 (MLA, MoE, MTP), Arctic, Mamba-2 and
RecurrentGemma each build and take a forward and a decode step, and
``lm_grad_fn`` takes one vmapped call on reduced DeepSeek-V3.  The dry run
(``shapes``, ``sharding``, ``launch.shardings``, ``launch.mesh``,
``launch.steps.bundle_for``, ``analysis.op_cost`` and ``roofline``,
``launch.dryrun``) traces a reduced train step on the meta device there
and counts full DeepSeek-V3's parameters without a card.  The quickstart
twin (``repro_torch.examples``) runs its calm-ring section at 4 workers
there, RMSNorm's custom VJP runs under ``vmap`` of ``grad``, and the
twin's ``main`` without ``--device cpu`` refuses."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (imported in this process only; the probe blocks it)
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["networkx"] = None     # and so does `import networkx`
    sys.modules["msgpack"] = None      # and `import msgpack`
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    leaked = sorted(k for k in sys.modules
                    if k == "repro" or k.startswith("repro.")
                    or k in ("jax", "networkx", "msgpack")
                    and sys.modules[k] is not None
                    or k.startswith(("jax.", "jaxlib", "networkx.",
                                     "msgpack.")))
    print("LEAKED", leaked)
    import repro_torch.optim, repro_torch.core.gossip
    from repro_torch.launch.gossip_train import GossipTrainer
    from repro_torch.core import matching_bank, params_from_graph
    from repro_torch.core import exponential_graph as expg
    print("BANK", matching_bank(expg(8)).shape)
    import torch
    g = expg(8)
    trainer = GossipTrainer(
        lambda p, b: (0.5 * ((p["w"] - b) ** 2).sum(), {}),
        repro_torch.optim.sgd(), g, params_from_graph(g), comms_per_step=2)
    state = trainer.init({"w": torch.zeros(5)},
                         torch.Generator().manual_seed(0))
    state, metrics = trainer.make_step()(state, torch.ones(8, 5))
    print("STEP", len(state.params), tuple(state.params[3]["w"].shape),
          bool(torch.isfinite(metrics["loss"])))
    from repro_torch.core import (Algorithm, World, WorldSweep,
                                  ring_graph)
    sweep = WorldSweep.over(World(ring_graph(8)),
                            algorithm=(Algorithm("adpsgd"), Algorithm()),
                            seeds=(0, 1))
    scheds = sweep.compile(4)
    print("WORLDS", len(scheds), World.from_json(sweep.worlds[1].to_json())
          == sweep.worlds[1])
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen3-0.6b", reduced=True)
    for impl in ("xla", "pallas"):
        model = Model(cfg.with_updates(attention_impl=impl))
        params = model.init(torch.Generator().manual_seed(0))
        logits, _, _ = model.forward(params, torch.zeros((1, 8),
                                                         dtype=torch.long))
        print("MODEL", impl, tuple(logits.shape))
    from repro_torch.core import Simulator, Telemetry, baseline_params
    from repro_torch.core import params_from_graph as pfg
    ring = ring_graph(8)
    tsim = Simulator(lambda x, g, ids: ((x ** 2).sum(1), x),
                     pfg(ring), 0.1, robust_clip=1.0, device="cpu")
    _, tr = tsim.run_world(tsim.init(torch.ones(6), 8, torch.Generator()),
                           World(ring, telemetry=Telemetry()), 3)
    tel = tr.telemetry
    print("TELEMETRY", tuple(tel.applied.shape), tel.row_bytes,
          bool(((tel.applied + tel.rejected).numpy() + tel.dropped
                == tel.scheduled).all()))
    from repro_torch.core import SplitGradFn
    from repro_torch.launch import MeshReplay, make_replay_mesh
    ssim = Simulator(SplitGradFn(lambda g, n: torch.randn(n, 6, generator=g),
                                 lambda x, noise, ids: ((x ** 2).sum(1),
                                                        x + 0.1 * noise)),
                     pfg(ring), 0.1, device="cpu")
    sharded = []
    for mesh in (None, MeshReplay(make_replay_mesh(2, devices=["cpu"] * 2))):
        sharded.append(ssim.run_worlds(
            [ssim.init(torch.ones(6), 8, torch.Generator().manual_seed(0))],
            [World(ring).compile(3)], mesh=mesh)[0])
    print("SHARDED", torch.equal(sharded[0].x, sharded[1].x),
          torch.equal(sharded[0].generator[0].get_state(),
                      sharded[1].generator[0].get_state()))
    from repro_torch.launch.steps import TrainState, make_train_step
    lm = Model(cfg)
    step, opt = make_train_step(lm, lr=0.05, remat=True)
    p0 = lm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 9), dtype=torch.long)
    st, met = step(TrainState(p0, opt.init(p0)),
                   {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    import tempfile
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.tree import tree_leaves, tree_map
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, st)
        n, back = restore(d, st)
    print("TRAIN", bool(torch.isfinite(met["loss"])), n, type(back).__name__,
          all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                tree_leaves(st.params))))
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.convert import params_from_jax
    refused = 0
    for make in (lambda: Simulator(None, baseline_params(1.0), 0.1),
                 lambda: SyntheticCIFAR(),
                 lambda: params_from_jax({}),
                 lambda: make_replay_mesh()):
        try:
            make()
        except RuntimeError:
            refused += 1
    print("CUDA", torch.cuda.is_available(), "REFUSED", refused)
    import numpy as np
    from repro_torch.configs.nano_lm import train_bench
    from repro_torch.core import ServeLoad
    from repro_torch.launch import serve
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.launch.fleet import GossipFleet
    qm = Model(cfg)
    qp = qm.init(torch.Generator().manual_seed(0))
    ids = serve.generate(qm, qp, torch.zeros((1, 3), dtype=torch.long), 4)
    print("SERVE", tuple(ids.shape))
    batcher = ContinuousBatcher(qm, qp, max_batch=2, max_len=16)
    for uid in range(3):
        batcher.submit(Request(uid, np.arange(1, 3 + uid, dtype=np.int32),
                               3))
    print("BATCH", sorted(len(r.out) for r in batcher.run_until_drained()))
    tb = Model(train_bench())
    fleet = GossipFleet(tb, tb.init(torch.Generator().manual_seed(0)),
                        World(ring_graph(3), serve=ServeLoad(
                            rate=1.0, prompt_len=(2, 3), gen_len=(2, 3))),
                        max_batch=2, max_len=8)
    rep = fleet.run(rounds=4, seed=0)
    print("FLEET", rep.rounds, rep.requests_total > 0,
          rep.lost + len(rep.completed) == rep.requests_total)
    from repro_torch.data import LMTaskStream
    from repro_torch.models.transformer import lm_grad_fn
    for arch in ("deepseek-v3-671b", "arctic-480b", "mamba2-780m",
                 "recurrentgemma-9b"):
        zc = get_config(arch, reduced=True)
        zm = Model(zc)
        zp = zm.init(torch.Generator().manual_seed(0))
        ztok = torch.zeros((1, 32), dtype=torch.long)
        zl, _, _ = zm.forward(zp, ztok)
        zd, _ = zm.decode_step(zp, ztok[:, :1], 0,
                               zm.init_cache(1, 4, device="cpu"))
        print("ZOO", arch, tuple(zl.shape), tuple(zd.shape),
              bool(torch.isfinite(zl).all() and torch.isfinite(zd).all()))
        if arch == "deepseek-v3-671b":
            zs = LMTaskStream(vocab_size=zc.vocab_size, seq_len=8,
                              batch_size=1, seed=0, device="cpu")
            zx = tree_map(lambda a: torch.stack([a, a]), zp)
            zloss, zg = lm_grad_fn(zm, zs)(zx, torch.Generator(),
                                           torch.arange(2))
            print("ZOO_GRAD", tuple(zloss.shape),
                  tuple(zg["mtp"]["proj"].shape),
                  bool(torch.isfinite(zloss).all()))
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    from repro_torch.launch.steps import bundle_for
    from repro_torch.shapes import InputShape, input_specs
    from repro_torch.sharding import SINGLE_POD_RULES
    dmesh = make_production_mesh()
    dspec = bundle_for(get_config("qwen3-0.6b", reduced=True),
                       InputShape("t", 64, 32, "train"), dmesh,
                       rules_for(dmesh))
    dcost = dspec.trace(dmesh)
    dcounts = dryrun._param_counts(Model(get_config("deepseek-v3-671b")))
    print("DRYRUN", dspec.arg_bytes(dmesh) > 0, dcost.flops > 0,
          dcost.peak_live_bytes > 0, dcounts["active"] < dcounts["total"],
          input_specs(get_config("qwen3-0.6b"), "decode_32k")["pos"].is_meta,
          model_flops(2, 1, 3, "train"), SINGLE_POD_RULES["fsdp"])
    refused = 0
    for make in (lambda: qm.init_cache(1, 4), lambda: serve.main([])):
        try:
            make()
        except RuntimeError:
            refused += 1
    print("SERVE_REFUSED", refused)
    from repro_torch.examples import quickstart
    calm = quickstart.calm_ring(quickstart.draw_b(4, 8), quickstart.NOISE,
                                5, "cpu")
    print("QUICKSTART", len(calm.lines), sorted(calm.runs),
          tuple(calm.runs["A2CiD2"].trace.consensus.shape),
          bool(torch.isfinite(calm.runs["A2CiD2"].trace.consensus).all()))
    from repro_torch.models.layers import rmsnorm
    rx, rs = torch.randn(3, 2, 16), torch.randn(3, 16)
    rgx, rgs = torch.func.vmap(torch.func.grad(
        lambda a, b: rmsnorm(a, b).sum(), argnums=(0, 1)))(rx, rs)
    print("RMSNORM", tuple(rgx.shape), tuple(rgs.shape),
          bool(torch.isfinite(rgx).all() and torch.isfinite(rgs).all()))
    try:
        quickstart.main(["--rounds", "2"])
        print("EXAMPLE_REFUSED", False)
    except RuntimeError:
        print("EXAMPLE_REFUSED", True)
""")


def test_port_imports_without_jax_and_refuses_cpu_by_default():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LEAKED", "WORLDS", "CUDA", "BANK",
                                     "STEP", "TELEMETRY", "TRAIN", "SERVE",
                                     "BATCH", "FLEET", "ZOO_GRAD",
                                     "SHARDED", "DRYRUN", "QUICKSTART",
                                     "RMSNORM", "EXAMPLE_REFUSED")))
    models = [line for line in out.stdout.splitlines()
              if line.startswith("MODEL")]
    assert models == ["MODEL xla (1, 8, 512)", "MODEL pallas (1, 8, 512)"]
    assert lines["LEAKED"] == "[]"
    assert lines["BANK"] == "(6, 8)"
    assert lines["STEP"] == "8 (5,) True"
    assert lines["WORLDS"] == "4 True"
    assert lines["TELEMETRY"] == "(3,) 24 True"
    assert lines["SHARDED"] == "True True"
    assert lines["TRAIN"] == "True 1 TrainState True"
    assert lines["SERVE"] == "(1, 7)"
    assert lines["BATCH"] == "[3, 3, 3]"
    assert lines["FLEET"] == "4 True True"
    zoo = [line for line in out.stdout.splitlines()
           if line.startswith("ZOO ")]
    assert zoo == [f"ZOO {arch} (1, 32, 512) (1, 1, 512) True"
                   for arch in ("deepseek-v3-671b", "arctic-480b",
                                "mamba2-780m", "recurrentgemma-9b")]
    assert lines["ZOO_GRAD"] == "(2,) (2, 512, 256) True"
    assert lines["DRYRUN"] == "True True True True True 18.0 data"
    assert lines["QUICKSTART"] == "3 ['A2CiD2', 'baseline'] (5,) True"
    assert lines["RMSNORM"] == "(3, 2, 16) (3, 16) True"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-refusal half does not apply")
    assert lines["CUDA"] == "False REFUSED 4"
    assert lines["SERVE_REFUSED"] == "2"
    assert lines["EXAMPLE_REFUSED"] == "True"


def test_explicit_cpu_is_accepted():
    from repro_torch.core import Simulator, baseline_params
    from repro_torch.data import SyntheticCIFAR
    assert Simulator(None, baseline_params(1.0), 0.1,
                     device="cpu").device.type == "cpu"
    assert SyntheticCIFAR(device="cpu").device.type == "cpu"


def test_unported_world_parts_raise():
    """A telemetry spec that is not a ``Telemetry`` raises JAX's
    ``ValueError``, a JSON spec loads as one; ``mesh=`` (the sharded
    replay, ported) runs on CPU shards and pins the single-device
    replay, and refuses something that is not a replay mesh."""
    from repro.core import World as JWorld
    from repro.core import ring_graph as j_ring
    from repro_torch.core import (Simulator, Telemetry, World,
                                  baseline_params, ring_graph)
    with pytest.raises(ValueError, match="telemetry") as terr:
        World(ring_graph(4), telemetry=object())
    with pytest.raises(ValueError, match="telemetry") as jerr:
        JWorld(j_ring(4), telemetry=object())
    assert str(terr.value) == str(jerr.value)
    loaded = World.from_json(World(ring_graph(4)).to_json().replace(
        '"telemetry": null', '"telemetry": {"shards": 2}'))
    assert loaded.telemetry == Telemetry(shards=2)
    sim = Simulator(None, baseline_params(1.0), 0.1, device="cpu")
    state = sim.init(torch.zeros(4), 4, torch.Generator())
    sched = World(ring_graph(4)).compile(2)
    from repro_torch.launch import MeshReplay, make_replay_mesh
    with pytest.raises(TypeError, match="replay mesh"):
        sim.run_worlds([state], [sched], mesh=object())
    quad = Simulator(lambda x, g, ids: ((x ** 2).sum(1), x),
                     baseline_params(1.0), 0.1, device="cpu")
    f0, _ = quad.run_worlds([state], [sched])
    f1, _ = quad.run_worlds([state], [sched], mesh=MeshReplay(
        make_replay_mesh(1, devices=["cpu"])))
    assert torch.equal(f0.x, f1.x) and torch.equal(f0.x_tilde, f1.x_tilde)
    with pytest.raises(ValueError, match="telemetry"):
        sim.run_worlds([state], [sched], telemetry=object())


def test_worlds_replay_on_cpu_takes_the_plain_version():
    """CPU tensors with the default backend run the plain versions and
    launch no kernel."""
    from repro_torch.core import Simulator, World, WorldSweep, ring_graph
    from repro_torch.core import params_from_graph
    from repro_torch.kernels.a2cid2_mixing import kernel

    def quad(x, generator, ids):
        return 0.5 * (x ** 2).sum(dim=1), x

    sim = Simulator(quad, params_from_graph(ring_graph(6)), 0.1,
                    device="cpu")
    sweep = WorldSweep.over(World(ring_graph(6)), comms_per_grad=(1.0, 2.0))
    states = [sim.init(torch.ones(8), 6, torch.Generator()) for _ in
              range(2)]
    before = (kernel.mixing_gossip_worlds.launches,
              kernel.channel_gossip_worlds.launches)
    for clips in (None, [1.0, None]):
        final, _ = sim.run_worlds(states, sweep.compile(3),
                                  robust_clips=clips)
        assert final.x.device.type == "cpu"
    assert (kernel.mixing_gossip_worlds.launches,
            kernel.channel_gossip_worlds.launches) == before
