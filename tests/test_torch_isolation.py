"""The port stands alone: importing every module of ``repro_torch`` with JAX
and networkx blocked loads nothing of the JAX package (a matching bank
builds and a ``GossipTrainer`` step runs there, and a ``World`` and a
``WorldSweep`` build and compile there, and a reduced transformer builds
and runs its forward on both attention paths), the entry points refuse to run on
a machine without a card unless the caller names the CPU, and the parts
not ported yet (the sharded and telemetry replays) raise instead of taking
another path."""
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
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    leaked = sorted(k for k in sys.modules
                    if k == "repro" or k.startswith("repro.")
                    or k in ("jax", "networkx") and sys.modules[k] is not None
                    or k.startswith(("jax.", "jaxlib", "networkx.")))
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
    from repro_torch.core import Simulator, baseline_params
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.convert import params_from_jax
    refused = 0
    for make in (lambda: Simulator(None, baseline_params(1.0), 0.1),
                 lambda: SyntheticCIFAR(),
                 lambda: params_from_jax({})):
        try:
            make()
        except RuntimeError:
            refused += 1
    print("CUDA", torch.cuda.is_available(), "REFUSED", refused)
""")


def test_port_imports_without_jax_and_refuses_cpu_by_default():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LEAKED", "WORLDS", "CUDA", "BANK",
                                     "STEP")))
    models = [line for line in out.stdout.splitlines()
              if line.startswith("MODEL")]
    assert models == ["MODEL xla (1, 8, 512)", "MODEL pallas (1, 8, 512)"]
    assert lines["LEAKED"] == "[]"
    assert lines["BANK"] == "(6, 8)"
    assert lines["STEP"] == "8 (5,) True"
    assert lines["WORLDS"] == "4 True"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-refusal half does not apply")
    assert lines["CUDA"] == "False REFUSED 3"


def test_explicit_cpu_is_accepted():
    from repro_torch.core import Simulator, baseline_params
    from repro_torch.data import SyntheticCIFAR
    assert Simulator(None, baseline_params(1.0), 0.1,
                     device="cpu").device.type == "cpu"
    assert SyntheticCIFAR(device="cpu").device.type == "cpu"


def test_unported_world_parts_raise():
    from repro_torch.core import Simulator, World, baseline_params, ring_graph
    with pytest.raises(NotImplementedError, match="telemetry"):
        World(ring_graph(4), telemetry=object())
    with pytest.raises(NotImplementedError, match="telemetry"):
        World.from_json(World(ring_graph(4)).to_json().replace(
            '"telemetry": null', '"telemetry": {"rounds": true}'))
    sim = Simulator(None, baseline_params(1.0), 0.1, device="cpu")
    state = sim.init(torch.zeros(4), 4, torch.Generator())
    sched = World(ring_graph(4)).compile(2)
    for kw, what in (({"mesh": object()}, "sharded"),
                     ({"telemetry": object()}, "telemetry")):
        with pytest.raises(NotImplementedError, match=what):
            sim.run_worlds([state], [sched], **kw)


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
