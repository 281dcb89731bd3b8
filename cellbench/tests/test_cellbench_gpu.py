"""On the card: each cell at a small size through the hand-written kernel,
sound runs correct and the TF32 control not, and a traced run that reads
the device.  Skips where there is no card."""

from __future__ import annotations

import pytest
import torch

from _cellbench_small import run, small, workloads
from cellbench import harness, layout

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' kernels run on the card only")
    return "cuda"


@pytest.mark.parametrize("workload", workloads())
def test_a_small_cell_on_the_card_is_correct_and_its_control_is_not(workload, card):
    assert run(workload, device=card, seconds=0.5)["correct"]
    assert not run(workload, device=card, seconds=0.5, control="tf32")["correct"]


@pytest.mark.parametrize("workload", workloads())
def test_a_traced_run_reads_the_device(workload, card):
    cfg, traffic = small(workload)
    traffic["trace_seconds"] = 0.3
    names = [m["name"] for m in layout.metrics_of(workload, "per_layer")]
    r = harness.run_cell(workload, cfg, traffic, seed=5, seconds=0.6, trace=True, device=torch.device(card),
                         metrics=names)
    assert r["correct"] and r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert r["breakdown"]["device_ops"]
    for name in names:
        if name.startswith(("fpca_kernel_ms", "replay_device_ms", "step_mfu")):
            assert r["metrics"][name]["value"] > 0
