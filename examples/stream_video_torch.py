"""Streaming video through the FPCA frontend, in PyTorch: temporal delta
gating + the double-buffered serving loop.

    PYTHONPATH=src python examples/stream_video_torch.py [--device cpu]

The torch twin of ``examples/stream_video.py``; runs on the CUDA card
unless ``--device`` names another, serving through the backend the device
takes (the fpca kernel on the card, its plain version on the host).

Two synthetic cameras watch scenes where only a small moving object changes
frame-to-frame.  Each stream's :class:`StreamSession` compares every frame
against its predecessor at region-skip block granularity; only changed
blocks (plus hysteresis and periodic keyframes) are read out, and the keep
mask is compacted before the kernel call, so skipped windows never
execute.  Both cameras fan into one device batch per tick, and up to two
ticks are in flight at once (host gating for frame t+1 overlaps device
compute for frame t).  ``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.mapping import FPCASpec
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.device import resolve_device
from repro_torch.fpca import DeltaGateConfig
from repro_torch.fpca.backends import default_backend_name
from repro_torch.serving.fpca_pipeline import FPCAPipeline
from repro_torch.serving.streaming import StreamServer

H = W = 96
N_FRAMES = 48


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("fitting bucket-select curvefit model (one-off calibration)...")
    model = fit_bucket_model(n_pixels=75, device=dev)
    spec = FPCASpec(image_h=H, image_w=W, out_channels=8, kernel=5, stride=5)
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(8, 5, 5, 3)).astype(np.float32) * 0.2

    pipe = FPCAPipeline(model, backend=default_backend_name(dev), device=dev)
    pipe.register("cam", spec, kernel)

    cams = {
        "lobby": SyntheticMovingObject((H, W), seed=1, speed=0.15),
        "dock": SyntheticMovingObject((H, W), seed=2, speed=0.23),
    }
    gate = DeltaGateConfig(threshold=0.02, hysteresis=1, keyframe_interval=24)

    def ticks():
        for t in range(N_FRAMES):
            yield {name: cam.frame_at(t) for name, cam in cams.items()}

    def run(gating: bool) -> tuple[float, StreamServer, list]:
        server = StreamServer(pipe, gate, depth=2, gating=gating)
        for name in cams:
            server.add_stream(name, "cam")
        t0 = time.perf_counter()
        out = []
        for results in server.run(ticks()):
            out.append({r.stream_id: r.counts for r in results})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, server, out

    run(gating=True)                      # warm the executable cache
    t_gated, server, counts = run(gating=True)
    t_dense, _, _ = run(gating=False)

    fps_gated = N_FRAMES * len(cams) / t_gated
    fps_dense = N_FRAMES * len(cams) / t_dense
    s = server.stats
    print(f"\n{len(cams)} cameras x {N_FRAMES} frames, depth-2 double buffering")
    print(f"delta-gated: {t_gated*1e3:7.1f} ms  ({fps_gated:6.0f} frames/s)")
    print(f"dense:       {t_dense*1e3:7.1f} ms  ({fps_dense:6.0f} frames/s)")
    print(f"speedup: {t_dense/t_gated:.2f}x  "
          f"kept windows: {s.windows_kept}/{s.windows_total} "
          f"({s.windows_kept/s.windows_total:.1%})")

    rep = server.sessions["lobby"].energy_report()
    print(f"\nlobby sensor accounting over {rep['frames']} frames "
          f"(executed windows only):")
    print(f"  cycles {rep['executed_cycles']}, "
          f"energy {rep['e_total']*1e6:.1f} uJ "
          f"({rep['energy_vs_dense']:.2f}x dense), "
          f"sensor-side fps {rep['fps_effective']:.0f} "
          f"({1/rep['latency_vs_dense']:.2f}x dense)")
    return {
        "gated_s": t_gated, "dense_s": t_dense,
        "windows_kept": s.windows_kept, "windows_total": s.windows_total,
        "counts": counts, "lobby": rep,
    }


if __name__ == "__main__":
    main()
