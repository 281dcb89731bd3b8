"""Quickstart: the FPCA pipeline end to end on one image, in PyTorch.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The torch twin of ``examples/quickstart.py``; runs on the CUDA card unless
``--device`` names another.

1. fit the bucket-select curvefit model against the circuit oracle;
2. run a 5x5x3, 8-channel, stride-5 in-pixel convolution on a synthetic
   image through the full analog pipeline (NVM encoding -> bitline reads ->
   SS-ADC up/down counting -> ReLU'd counts);
3. report model error, linearity and the frontend energy/latency/bandwidth
   numbers for this configuration (paper Fig. 7/8/9).

Like the original it evaluates the dense simulation (the oracle), not the
fpca kernel.  ``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    ADCConfig,
    CircuitParams,
    FPCASpec,
    WeightEncoding,
    analog_dot_product,
    bandwidth_reduction,
    fit_bucket_model,
    fpca_forward,
    frontend_energy,
    frontend_latency,
    predict_sigmoid,
)
from repro_torch.device import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = CircuitParams()
    print("fitting bucket-select curvefit model (one-off)...")
    model = fit_bucket_model(params, device=dev)

    rng = np.random.default_rng(0)
    I = torch.as_tensor(rng.uniform(0, 1, (512, 75)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.uniform(0, 1, (512, 75)), dtype=torch.float32, device=dev)
    err = (predict_sigmoid(model, I, W) - analog_dot_product(I, W, params)).abs()
    max_err = float(err.max())
    print(f"bucket model max error: {max_err*100:.2f}% of full scale (paper: <3%)")

    spec = FPCASpec(image_h=120, image_w=120, out_channels=8, kernel=5, stride=5)
    image = torch.as_tensor(rng.uniform(0, 1, (120, 120, 3)), dtype=torch.float32, device=dev)
    kernel = torch.as_tensor(rng.normal(0, 0.2, (8, 5, 5, 3)), dtype=torch.float32, device=dev)
    out = fpca_forward(
        image, kernel, spec, circuit=params, model=model,
        adc=ADCConfig(), enc=WeightEncoding(), mode="bucket_sigmoid",
    )
    counts = out["counts"]
    print(f"activation map: {tuple(counts.shape)}, counts in [{float(counts.min()):.0f}, "
          f"{float(counts.max()):.0f}] (8-bit SS-ADC)")

    e = frontend_energy(spec)
    lat = frontend_latency(spec)
    br = bandwidth_reduction(spec)
    print(f"frontend: N_C={e['n_cycles']} cycles, E={e['e_total']*1e6:.2f} uJ/frame, "
          f"{lat['fps']:.1f} fps, BR={br:.1f}x")
    return {
        "max_err": max_err,
        "counts_shape": tuple(counts.shape),
        "counts": counts.cpu().numpy(),
        "n_cycles": e["n_cycles"],
        "e_total": e["e_total"],
        "fps": lat["fps"],
        "bandwidth_reduction": br,
    }


if __name__ == "__main__":
    main()
