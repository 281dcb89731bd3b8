#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  In order it

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each,
   all at once) into ``build/kernels``;
3. fits the bucket curvefit model on the card;
4. compiles the fpca_cnn model at full width (120x120x3 frames, 8 channels,
   4608 -> 64 -> 2 head) with random weights from a seeded generator;
5. serves requests through ``CompiledModel.run``: batches of 1, 64 and 256
   frames, one region-skip request keeping ~10% of the blocks, one
   all-skipped request; counts the kernel launches of that run;
6. holds each kernel of the path against its plain PyTorch version on the
   card, and the served counts and logits against the dense oracle;
7. times each kernel, its plain version and its bound.

It prints one JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``; a failed phase exits non-zero before
that line, as does a host with no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import fpca  # noqa: E402
from repro_torch.configs import fpca_cnn  # noqa: E402
from repro_torch.core.curvefit import fit_bucket_model  # noqa: E402
from repro_torch.core.fpca_sim import encode_weights, extract_windows  # noqa: E402
from repro_torch.core.mapping import active_window_mask  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fpca_conv.kernel import (  # noqa: E402
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    weight_planes,
)

SEED = 0
BATCHES = (1, 64, 256)
# NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth and non-tensor fp32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
COUNT_TOL, FLIP_TOL = 1.0, 0.05   # <= 1 ADC count, < 5% of counts off


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def count_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    d = (a - b).abs()
    return float(d.max()), float((d > 0).float().mean())


def time_cuda(fn, iters: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Median device milliseconds of ``fn()``.  The 50 MB L2 is flushed
    before each timed call, so every call reads its inputs from device
    memory; everything is enqueued before one synchronise, so the card never
    waits on the host inside a timed interval (the flush covers the host's
    launch time of the next call)."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def logit_bound(head: list[dict], d_counts: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-example bound on |Δlogits| of the Dense(relu) -> Dense head from
    count differences ``d_counts`` (relu is 1-Lipschitz, so
    |Δlogits| <= |W2|^T |W1|^T |Δx|)."""
    dx = d_counts.abs().reshape(d_counts.shape[0], -1) * scale
    return (dx @ head[0]["w"].abs()) @ head[1]["w"].abs()


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device is available")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    check(torch.get_float32_matmul_precision() == "highest", "fp32 matmuls must stay IEEE")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s, built {sorted(logs) or 'nothing (cached)'}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # ---- 3. fit + 4. compile ----------------------------------------------
    t0 = time.perf_counter()
    bucket_model = fit_bucket_model(device=dev)
    print(f"fit_bucket_model on {name}: {time.perf_counter() - t0:.2f} s")
    prog = fpca_cnn.make_model_program()
    spec = prog.spec
    g = torch.Generator().manual_seed(SEED)
    kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
    bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
    head = prog.init_head(g, device=dev)
    model = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head,
                         model=bucket_model)
    check(model.backend.name == "cuda", f"default backend on the card is {model.backend.name}")
    frames = {b: torch.rand((b, spec.image_h, spec.image_w, spec.in_channels), generator=g).to(dev)
              for b in BATCHES}
    bh, bw = -(-spec.eff_h // spec.skip_block), -(-spec.eff_w // spec.skip_block)
    rng = np.random.default_rng(SEED)
    sparse = np.zeros(bh * bw, bool)
    sparse[rng.choice(bh * bw, size=round(0.1 * bh * bw), replace=False)] = True
    sparse = sparse.reshape(bh, bw)
    requests = [(f"dense b={b}", frames[b], None) for b in BATCHES]
    requests += [("10% blocks b=64", frames[64], sparse),
                 ("all skipped b=64", frames[64], np.zeros((bh, bw), bool))]

    # ---- 5. the main path, with the launch counts ---------------------------
    for label, x, mask in requests:          # warm-up: first-call costs out of the timing
        model.run(x, block_mask=mask)
    torch.cuda.synchronize()
    fpca_conv_cuda.launches = 0
    served = []
    for label, x, mask in requests:
        before = fpca_conv_cuda.launches
        t0 = time.perf_counter()
        logits = model.run(x, block_mask=mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = fpca_conv_cuda.launches - before
        served.append((label, x, mask, logits))
        check(tuple(logits.shape) == (x.shape[0], prog.n_classes), f"{label}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        skipped = mask is not None and not mask.any()
        check(launched == (0 if skipped else 1), f"{label}: {launched} fpca_conv launches")
        print(f"request {label}: {ms:.3f} ms host clock, fpca_conv launches {launched}")
    launches = fpca_conv_cuda.launches
    check(launches >= 1, "the main path never launched fpca_conv_cuda")
    print(f"main path: {len(requests)} requests, fpca_conv_cuda launches {launches}, "
          f"stats {model.stats.snapshot()}")

    # request latency, host clock around synchronised runs (median of 10)
    latency = {}
    for label, x, mask in requests:
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            model.run(x, block_mask=mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[label] = statistics.median(times)
        print(f"latency {label}: median {latency[label]:.3f} ms "
              f"({x.shape[0] / latency[label] * 1e3:.1f} frames/s)")

    # ---- 6a. kernel vs plain version at the path's full shape ----------------
    w_pos, w_neg = encode_weights(kernel.to(dev), spec, prog.frontend.enc)
    tables = conv_tables(bucket_model, prog.frontend.adc, spec.n_active_pixels, dev)
    planes = weight_planes(w_pos.T, w_neg.T, tables)
    patches = extract_windows(frames[256], spec).reshape(-1, spec.n_active_pixels).contiguous()
    bn_dev = bn.to(dev)
    got = fpca_conv_cuda(patches, planes, tables, bn_dev)
    want = fpca_conv_basis(patches, planes, tables, bn_dev)
    torch.cuda.synchronize()
    max_err, flips = count_diff(got, want)
    print(f"fpca_conv kernel vs plain at M={patches.shape[0]}: max|Δcount| {max_err}, flips {flips:.2e}")
    check(max_err <= COUNT_TOL and flips < FLIP_TOL, "fpca_conv kernel disagrees with its plain version")
    valid = (torch.arange(patches.shape[0], device=dev) % 3 != 0).float()
    got_v = fpca_conv_cuda(patches, planes, tables, bn_dev, row_valid=valid)
    check(bool((got_v[valid == 0] == 0).all()) and torch.equal(got_v[valid == 1], got[valid == 1]),
          "row_valid must zero padding rows and leave real rows bit-identical")

    # ---- 6b. served outputs vs the dense oracle and the in-port invariants ---
    ref = fpca.compile(prog, backend="reference", device=dev, weights=kernel, bn_offset=bn,
                       head_params=head, model=bucket_model)
    small = frames[64][:2]
    c_cuda = model.run_frontend_weighted(model.kernel, model.bn_offset, small)
    c_ref = ref.run_frontend_weighted(ref.kernel, ref.bn_offset, small)
    err_ref, flips_ref = count_diff(c_cuda, c_ref)
    print(f"served counts vs dense oracle (2 frames): max|Δcount| {err_ref}, flips {flips_ref:.2e}")
    check(err_ref <= COUNT_TOL and flips_ref < FLIP_TOL, "served counts disagree with the oracle")
    l_cuda, l_ref = model.run(small), ref.run(small)
    bound = logit_bound(head, c_cuda - c_ref, prog.input_scale) + 1e-4 * l_ref.abs() + 1e-4
    print(f"served logits vs oracle: max|Δlogit| {float((l_cuda - l_ref).abs().max()):.3e}")
    check(bool(((l_cuda - l_ref).abs() <= bound).all()), "logits differ by more than the count bound")
    label, x, mask, logits = served[3]
    keep = torch.as_tensor(active_window_mask(spec, mask), device=dev)
    dense = model.run_frontend_weighted(model.kernel, model.bn_offset, x)
    compact = model.run_frontend_weighted(model.kernel, model.bn_offset, x,
                                          np.broadcast_to(keep.cpu().numpy(), dense.shape[:3]))
    check(torch.equal(compact, dense * keep[None, :, :, None]),
          "region-skip compacted counts must equal masked dense counts bit for bit")
    check(torch.equal(logits, model.head_logits(compact)), "masked logits must be head(compacted counts)")
    print(f"region skip: {int(keep.sum())}/{keep.numel()} windows kept per frame, compact == masked dense")

    # ---- 7. timings and bound ------------------------------------------------
    ms = time_cuda(lambda: fpca_conv_cuda(patches, planes, tables, bn_dev))
    plain_ms = time_cuda(lambda: fpca_conv_basis(patches, planes, tables, bn_dev))
    M, N = patches.shape
    C = prog.out_channels
    bytes_moved = 4 * (M * N + M * C)
    flops = 2 * 3 * M * C * N * 2        # 2 phases x 3 dot products x M*C*N FMAs
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3
    print(f"fpca_conv at M={M}, N={N}, C={C} on {smi}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, fp32 ops {t_ops:.4f})")

    for b in (1, 256):
        device_ms, rows = profile_request(model, frames[b])
        print(f"profile dense b={b}: device time {device_ms:.4f} ms per run, busy "
              f"{device_ms / latency[f'dense b={b}']:.1%} of the median request")
        for row in rows:
            print(f"  {row}")

    kernels = [{
        "name": "fpca_conv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fpca_conv.cu",
        "replaces": "src/repro/kernels/fpca_conv/kernel.py:90",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes the bucket-gated basis bank
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def profile_request(model, x: torch.Tensor) -> tuple[float, list[str]]:
    """Device milliseconds of one ``run`` and its split by kernel name
    (torch.profiler over 5 runs), top 8."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            model.run(x)
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy/memset), not the host ops that launch them
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    if not events:
        return float("nan"), ["torch.profiler recorded no device time"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events)
    return total / 5 / 1e3, [
        f"{e.key[:60]:60s} {e.device_time_total / 5 / 1e3:.4f} ms/run "
        f"({100 * e.device_time_total / total:.1f}%) x{e.count // 5}" for e in events[:8]
    ]


if __name__ == "__main__":
    main()
