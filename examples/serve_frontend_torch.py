"""Serve a heterogeneous FPCA frontend workload through the batched
pipeline, in PyTorch.

    PYTHONPATH=src python examples/serve_frontend_torch.py [--device cpu]

The torch twin of ``examples/serve_frontend.py``; runs on the CUDA card
unless ``--device`` names another.  Registers three field-programmed
configurations on one simulated pixel array (dense 5x5 stride-5,
overlapping 3x3 stride-2, and a binned low-power mode), then streams a
shuffled mix of frames through the spec-bucketed scheduler:

* requests are grouped per configuration and served as one fused batched
  kernel call each;
* every compile signature is one explicit ``repro_torch.fpca.CompiledFrontend``
  handle; all handles share one bounded LRU executable cache — reprogramming
  weights does not recompile;
* the backend is the one the device takes: the fpca kernel on the card,
  its plain version (``basis``) on the host.

``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import fpca
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.mapping import FPCASpec
from repro_torch.device import resolve_device
from repro_torch.fpca.backends import default_backend_name
from repro_torch.serving.fpca_pipeline import FPCAPipeline, FrontendRequest


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = default_backend_name(dev)

    print("fitting bucket-select curvefit model (one-off calibration)...")
    model = fit_bucket_model(n_pixels=75, device=dev)

    rng = np.random.default_rng(0)
    spec = FPCASpec(image_h=80, image_w=80, out_channels=8, kernel=5, stride=5)

    # -- the unified API on one handle: compile -> run -> reprogram ----------
    kernel = rng.normal(size=(8, 5, 5, 3)).astype(np.float32) * 0.2
    fe = fpca.compile(fpca.FPCAProgram(spec=spec), backend=backend, device=dev,
                      weights=kernel, model=model)
    batch = rng.uniform(0, 1, (4, 80, 80, 3)).astype(np.float32)
    counts = fe.run(batch)
    fe.reprogram(rng.normal(size=(8, 5, 5, 3)).astype(np.float32) * 0.2)
    counts = fe.run(batch)                      # same executable, new weights
    info = fe.cache_info()
    print(f"compiled handle: {tuple(counts.shape)} counts; cache {info.misses} "
          f"compiles across {fe.stats.reprograms} reprograms "
          f"(hits={info.hits})")

    # -- heterogeneous fleet serving through the pipeline layer --------------
    pipe = FPCAPipeline(model, backend=backend, device=dev, cache_capacity=4)
    configs = {
        "dense_5x5": spec,
        "overlap_3x3": FPCASpec(image_h=80, image_w=80, out_channels=8, kernel=3, stride=2),
        "binned_lowpower": FPCASpec(
            image_h=80, image_w=80, out_channels=8, kernel=5, stride=5, binning=2
        ),
    }
    out_shapes = {}
    for name, s in configs.items():
        k = s.kernel
        cfg = pipe.register(
            name, s,
            rng.normal(size=(s.out_channels, k, k, 3)).astype(np.float32) * 0.2,
        )
        out_shapes[name] = tuple(cfg.out_shape)
        print(f"registered {name}: out_shape={cfg.out_shape}")

    names = list(configs)
    requests = [
        FrontendRequest(
            config=names[int(rng.integers(len(names)))],
            image=rng.uniform(0, 1, (80, 80, 3)).astype(np.float32),
        )
        for _ in range(48)
    ]

    t0 = time.perf_counter()
    results = pipe.serve(requests)   # cold: includes compiles
    _sync(dev)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = pipe.serve(requests)   # warm: pure serving
    _sync(dev)
    t_warm = time.perf_counter() - t0

    print(f"served {len(results)} frames across {len(configs)} specs")
    print(f"cold {t_cold*1e3:.0f} ms, warm {t_warm*1e3:.1f} ms "
          f"({len(results)/t_warm:.0f} frames/s warm)")
    s = pipe.stats
    print(f"stats: {s.requests} requests in {s.batches} fused batches, "
          f"cache {s.cache_hits} hits / {s.cache_misses} misses / "
          f"{s.evictions} evictions")
    return {
        "handle_counts": counts.cpu().numpy(),
        "handle_misses": info.misses,
        "handle_hits": info.hits,
        "reprograms": fe.stats.reprograms,
        "out_shapes": out_shapes,
        "results": [torch.as_tensor(r).cpu().numpy() for r in results],
        "configs": [r.config for r in requests],
        "served": len(results),
        "requests": s.requests,
        "batches": s.batches,
        "cache_hits": s.cache_hits,
        "cache_misses": s.cache_misses,
        "evictions": s.evictions,
        "cold_s": t_cold,
        "warm_s": t_warm,
    }


if __name__ == "__main__":
    main()
