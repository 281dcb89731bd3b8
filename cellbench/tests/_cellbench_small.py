"""Small copies of the cells for the host: the configuration's file and the
mix's file of each cell, with the frames cut to 20 x 20 and the traffic to
a few frames, everything else as committed."""

from __future__ import annotations

import torch

from cellbench import harness, layout

SHRINK = {
    "dense_batches": {"batch": 2},
    "camera_segments": {"cameras": 2, "clip_ticks": 8, "segment": 4, "checked_calls": 4},
}


def small(workload: str) -> tuple[dict, dict]:
    entry = layout.cell(workload)
    cfg, traffic = layout.config(entry), layout.traffic(entry["traffic"])
    cfg.update(image_h=20, image_w=20)
    traffic.update(SHRINK[traffic["driver"]])
    if traffic["frames"]["kind"] == "moving_object" and "clip_ticks" in traffic["frames"]:
        traffic["frames"] = {**traffic["frames"], "clip_ticks": traffic["batch"]}
    return cfg, traffic


def run(workload: str, *, seed: int = 2**31 + 7, seconds: float = 0.3, control: str | None = None,
        device: str = "cpu") -> dict:
    """One small run of ``workload`` (end-to-end metrics) on ``device``."""
    cfg, traffic = small(workload)
    names = [m["name"] for m in layout.metrics_of(workload, "end_to_end")]
    return harness.run_cell(workload, cfg, traffic, seed=seed, seconds=seconds, trace=False,
                            device=torch.device(device), metrics=names, control=control)


def workloads() -> list[str]:
    return [w["name"] for w in layout.benchmark()["workloads"]]
