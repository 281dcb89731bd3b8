"""The check on the host at small sizes: sound runs come out correct, the
TF32 control and each fault a cell can have come out not correct.  The
runs go through the harness as a chip run does, only its look for the card
is skipped (``harness.run_cell`` on the host)."""

from __future__ import annotations

import pytest

import _cellbench_faults as faults
from _cellbench_small import run, small, workloads

STREAM = [w for w in workloads() if "segments" in w]
NETWORKS = [w for w in workloads() if small(w)[0]["head"]]


@pytest.mark.parametrize("workload", workloads())
def test_a_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(r)[-2:] == ["checks", "lines"]


@pytest.mark.parametrize("workload", workloads())
def test_the_tf32_control_is_not_correct(workload):
    r = run(workload, control="tf32")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("fault", sorted(faults.KERNEL))
def test_a_broken_kernel_is_not_correct(workload, fault, monkeypatch):
    faults.KERNEL[fault](monkeypatch)
    r = run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", NETWORKS)
def test_a_frame_whose_logits_are_altered_is_not_correct(workload, monkeypatch):
    faults.row_altered(monkeypatch)
    r = run(workload, seconds=0.5)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", STREAM)
def test_a_segment_that_returns_its_state_unchanged_is_not_correct(workload, monkeypatch):
    faults.state_unchanged(monkeypatch)
    r = run(workload, seconds=0.5)
    assert not r["correct"], r["checks"]
