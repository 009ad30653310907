"""The output check's control on the card, at a size a test run holds
(the ResNet-8 cell of ``conftest.tiny_bench``): the reference with its
products on the TF32 tensor cores reads at least three times what sound
runs of the program read, on one of the check's numbers, and each planted
fault ten times.  ``python3 -m perfbench.calibrate`` reads the same at a
cell's own size.  Run on the card with ``PYTHONPATH=src python3 -m pytest
-m gpu perfbench/``."""
from __future__ import annotations

import pytest
import torch

from perfbench import calibrate
from perfbench.conftest import RESNET


@pytest.mark.gpu
def test_control_and_faults_fail_where_sound_runs_pass(tiny_bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = calibrate.readings(tiny_bench, RESNET, [1, 2, 3], [4, 5, 6],
                             torch.device("cuda"))
    lower = out["lower"]
    for kind, factor in (("tf32", 3), ("half_batch", 10),
                         ("no_exchange", 10)):
        upper = out["upper"][kind]
        assert any(upper[k] >= factor * lower[k] for k in lower), kind
