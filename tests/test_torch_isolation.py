"""The port stands alone: importing every module of ``repro_torch`` with JAX
blocked loads nothing of the JAX package, and the entry points refuse to
run on a machine without a card unless the caller names the CPU."""
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
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    leaked = sorted(k for k in sys.modules
                    if k == "repro" or k.startswith("repro.")
                    or k == "jax" and sys.modules[k] is not None
                    or k.startswith("jax.") or k.startswith("jaxlib"))
    print("LEAKED", leaked)
    import torch
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
                 if line.startswith(("LEAKED", "CUDA")))
    assert lines["LEAKED"] == "[]"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-refusal half does not apply")
    assert lines["CUDA"] == "False REFUSED 3"


def test_explicit_cpu_is_accepted():
    from repro_torch.core import Simulator, baseline_params
    from repro_torch.data import SyntheticCIFAR
    assert Simulator(None, baseline_params(1.0), 0.1,
                     device="cpu").device.type == "cpu"
    assert SyntheticCIFAR(device="cpu").device.type == "cpu"
