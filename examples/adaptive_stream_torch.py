"""Adaptive streaming control plane, in PyTorch: keep-fraction servo,
sticky buckets, multi-config fan-out.

    PYTHONPATH=src python examples/adaptive_stream_torch.py [--device cpu] [--telemetry PATH]

The torch twin of ``examples/adaptive_stream.py``; runs on the CUDA card
unless ``--device`` names another, serving through the backend the device
takes (the fpca kernel on the card, its plain version on the host).

A synthetic camera watches a scene with one moving object.  Instead of the
fixed gate threshold of ``stream_video_torch.py``, a per-stream
:class:`~repro_torch.serving.control.GateController` closed-loop servos the
threshold until the stream settles at a **kept-window budget** (15% here).
The pipeline's sticky row buckets (``bucket_patience``) ride out the
bucket flapping that keyframes and busy ticks would otherwise cause, and
the camera is fanned out to TWO programmed configurations (an "edges" and
a "blobs" kernel bank) served by ONE channel-stacked kernel call per tick
(12 channels: on the card the kernel's tensor-core design in two channel
blocks, each config's counts those of its own launch).

The whole run serves under a live telemetry session
(``telemetry.enable``): every serve tick is a traced span, every servo
actuation is a JSONL event (written to ``--telemetry``, by default a file
in the temporary directory), and the closing fleet report / Prometheus
snapshot come straight off the same registry cells the stats objects
read.  ``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.mapping import FPCASpec
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.device import resolve_device
from repro_torch.fpca import DeltaGateConfig, GateControllerConfig, telemetry
from repro_torch.fpca.backends import default_backend_name
from repro_torch.serving.fpca_pipeline import FPCAPipeline
from repro_torch.serving.observe import fleet_report, render_fleet_report
from repro_torch.serving.streaming import StreamServer

H = W = 96
N_FRAMES = 40
TARGET = 0.15


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--telemetry", metavar="JSONL", default=None,
                    help="the telemetry event file (default: "
                         "adaptive_stream_torch_telemetry.jsonl in the temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("fitting bucket-select curvefit model (one-off calibration)...")
    model = fit_bucket_model(n_pixels=75, device=dev)
    spec = FPCASpec(image_h=H, image_w=W, out_channels=8, kernel=5, stride=5)
    rng = np.random.default_rng(0)
    k_edges = rng.normal(size=(8, 5, 5, 3)).astype(np.float32) * 0.2
    k_blobs = rng.normal(size=(4, 5, 5, 3)).astype(np.float32) * 0.2

    pipe = FPCAPipeline(model, backend=default_backend_name(dev), device=dev, bucket_patience=4)
    pipe.register("edges", spec, k_edges)
    pipe.register("blobs", spec, k_blobs)

    server = StreamServer(
        pipe,
        DeltaGateConfig(threshold=0.02, hysteresis=1, keyframe_interval=0),
        controller=GateControllerConfig(target=TARGET),
    )
    # one camera, fanned to BOTH configs: one stacked kernel call per tick.
    # Each config gets its OWN gate + servo (per-config thresholds): "edges"
    # servos to the tight budget, "blobs" to a looser one — the fused call
    # executes the union mask, each config's counts honour its own gate.
    server.add_stream(
        "cam0", ("edges", "blobs"),
        gate={
            "edges": DeltaGateConfig(threshold=0.02, hysteresis=1, keyframe_interval=0),
            "blobs": DeltaGateConfig(threshold=0.05, hysteresis=1, keyframe_interval=0),
        },
        controller={
            "edges": GateControllerConfig(target=TARGET),
            "blobs": GateControllerConfig(target=2 * TARGET),
        },
    )
    cam = SyntheticMovingObject((H, W), seed=1, radius=12.0)

    jsonl = Path(args.telemetry or Path(tempfile.gettempdir()) / "adaptive_stream_torch_telemetry.jsonl")
    telemetry.enable(jsonl, device_time_rate=8,
                     run_labels={"example": "adaptive_stream"})
    try:
        res = _serve(server, pipe, cam)
        n_events = telemetry.session().events_written
    finally:
        telemetry.disable()
    events = telemetry.read_jsonl(jsonl)
    spans = sum(1 for e in events if e["event"] == "span")
    servo = sum(1 for e in events if e["event"] == "servo_actuate")
    print(f"\ntelemetry: {n_events} JSONL events -> {jsonl} "
          f"({spans} spans, {servo} servo actuations)")
    snap = telemetry.registry().render()
    line = next(l for l in snap.splitlines()
                if l.startswith("fpca_gate_threshold"))
    print(f"prometheus snapshot: {len(snap.splitlines())} lines, e.g. {line}")
    res["telemetry"] = {"events": n_events, "spans": spans, "servo": servo,
                        "snapshot_lines": len(snap.splitlines()), "threshold_line": line}
    return res


def _serve(server: StreamServer, pipe: FPCAPipeline, cam: SyntheticMovingObject) -> dict:
    print(f"\nservoing gate threshold to a {TARGET:.0%} kept-window budget:")
    print(f"{'tick':>4} {'threshold':>10} {'kept EMA':>9}  configs served")
    n_results = 0
    history, counts = [], []
    for results in server.run({"cam0": cam.frame_at(t)} for t in range(N_FRAMES)):
        n_results += len(results)
        counts.append({r.config: r.counts for r in results})
        ctl = server.sessions["cam0"].controller
        h = ctl.history[-1]
        history.append((h["tick"], h["threshold"], h["ema"]))
        if h["tick"] % 4 == 0:
            ema = "---" if h["ema"] is None else f"{h['ema']:9.3f}"
            served = ", ".join(
                f"{r.config}{tuple(r.counts.shape)}" for r in results
            )
            print(f"{h['tick']:>4} {h['threshold']:>10.4f} {ema}  {served}")

    session = server.sessions["cam0"]
    ctl = session.controller                      # primary config ("edges")
    conv = ctl.converged_tick(rel_tol=0.2)
    print(f"\nedges converged to ±20% of budget at tick {conv} "
          f"(final threshold {ctl.threshold:.4f}, EMA {ctl.ema:.3f})")
    ctl_b = session.state_for("blobs").controller
    print(f"blobs servoed independently to its own {2*TARGET:.0%} budget "
          f"(threshold {ctl_b.threshold:.4f}, EMA {ctl_b.ema:.3f})")
    print(f"fan-out: {pipe.stats.fanout_batches} stacked calls served "
          f"{n_results} (stream, config) results")
    print(f"sticky buckets: {server.stats.bucket_switches} executable "
          f"switches, {server.stats.bucket_shrinks_deferred} shrinks deferred"
          f" (patience {pipe.bucket_patience})")
    print(f"all-skipped ticks short-circuited: {server.stats.launches_skipped}")

    rep = server.sessions["cam0"].energy_report()
    print(f"\nsensor accounting over {rep['frames']} frames: "
          f"kept {rep['kept_window_frac']:.1%} of windows, "
          f"energy {rep['energy_vs_dense']:.2f}x dense")

    # -- telemetry export surfaces --------------------------------------
    print("\nfleet report (per stream x config):")
    print(render_fleet_report(fleet_report(server)))
    return {
        "history": history, "counts": counts, "converged_tick": conv,
        "edges": {"threshold": ctl.threshold, "ema": ctl.ema},
        "blobs": {"threshold": ctl_b.threshold, "ema": ctl_b.ema},
        "fanout_batches": pipe.stats.fanout_batches, "results": n_results,
        "bucket_switches": server.stats.bucket_switches,
        "shrinks_deferred": server.stats.bucket_shrinks_deferred,
        "launches_skipped": server.stats.launches_skipped,
        "accounting": rep,
    }


if __name__ == "__main__":
    main()
