"""Time the fpca kernel from one source tree, for an A/B of two trees in one call.

    python tools/fpca_kernel_ab.py <src> [C ...]

``<src>`` is the ``src`` directory of a checkout (for the parent commit,
``git archive <parent> src`` unpacked into a git-ignored directory such as
``build/parent``); its kernels build under that checkout.  On one CUDA card,
at M = 147,456 windows of N = 75 pixels (fpca_cnn at batch 256, uniform
random patches and weights from seed 0) and each channel count C (default
8), it prints ptxas's register and spill lines and one JSON line: per C the
wrapper's time (``ms``: median of 30 launches, each behind an L2 flush),
the SIMT design's through the C entry point, the launches by design, and the
largest count difference and flip share against the plain version.  Run the
trees in turns (parent, change, change, parent) within one call.
"""

import json
import statistics
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.core.adc import ADCConfig  # noqa: E402
from repro_torch.core.curvefit import fit_bucket_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fpca_conv import kernel as K  # noqa: E402


def time_cuda(fn, iters: int = 30) -> float:
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> None:
    for src, log in _build.build(["fpca_conv"]).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas", src, line.strip())
    dev = torch.device("cuda")
    tables = K.conv_tables(fit_bucket_model(n_pixels=75, device=dev), ADCConfig(), 75, dev)
    g = torch.Generator().manual_seed(0)
    patches = torch.rand((147456, 75), generator=g).to(dev)
    out = {"src": sys.argv[1]}
    for c in [int(a) for a in sys.argv[2:]] or [8]:
        w = torch.rand((75, c), generator=g).to(dev)
        planes = K.weight_planes(w, w.roll(1, dims=1), tables)
        bn = torch.randint(0, 30, (c,), generator=g).float().to(dev)
        got = K.fpca_conv_cuda(patches, planes, tables, bn)
        want = K.fpca_conv_basis(patches, planes, tables, bn)
        simt = torch.empty_like(got)
        assert K._launch(patches, planes, tables, bn, None, simt, tensor_cores=False) == 0
        torch.cuda.synchronize()
        d = (got - want).abs()
        ms = time_cuda(lambda: K.fpca_conv_cuda(patches, planes, tables, bn))
        simt_ms = time_cuda(lambda: K._launch(patches, planes, tables, bn, None, simt, tensor_cores=False))
        out[c] = {"ms": ms, "simt_ms": simt_ms, "designs": dict(K.fpca_conv_cuda.designs),
                  "max_err": float(d.max()), "flips": float((d > 0).float().mean()),
                  "simt_vs_tc_flips": float((simt != got).float().mean())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
