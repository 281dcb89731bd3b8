"""Time the fpca kernel from one source tree, for an A/B of two trees in one call.

    python tools/fpca_kernel_ab.py <src> [C ...]
    python tools/fpca_kernel_ab.py <src> --frames

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

With ``--frames``, at the benchmark's two dense cells (256 frames of
1120x1120x3, M = 12,845,056; 16,384 of 120x120x3, M = 9,437,184; C = 8,
stride = kernel = 5) it times instead the copy that makes the patch matrix
(``extract_windows``), the patch source's launch on it and, where the tree
has it, the frames source's launch on the frames (``fpca_conv_frames_cuda``),
and checks that the two sources' counts are equal.
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


def frames_ab(dev, tables, g) -> dict:
    from repro_torch.core.fpca_sim import extract_windows
    from repro_torch.core.mapping import FPCASpec

    w = torch.rand((75, 8), generator=g).to(dev)
    planes = K.weight_planes(w, w.roll(1, dims=1), tables)
    bn = torch.randint(0, 30, (8,), generator=g).float().to(dev)
    frames_cuda = getattr(K, "fpca_conv_frames_cuda", None)   # a tree before the frames source has none
    on_card = torch.Generator(dev).manual_seed(0)
    out = {}
    for b, size in ((256, 1120), (16384, 120)):
        frames = torch.rand((b, size, size, 3), generator=on_card, device=dev)
        spec = FPCASpec(image_h=size, image_w=size, out_channels=8, kernel=5, stride=5)

        def copy():
            return extract_windows(frames, spec).reshape(-1, 75).contiguous()

        patches = copy()
        row = {"M": patches.shape[0], "copy_ms": time_cuda(copy),
               "patches_ms": time_cuda(lambda: K.fpca_conv_cuda(patches, planes, tables, bn))}
        if frames_cuda is not None:
            row["equal"] = torch.equal(frames_cuda(frames, 5, planes, tables, bn),
                                       K.fpca_conv_cuda(patches, planes, tables, bn))
            row["frames_ms"] = time_cuda(lambda: frames_cuda(frames, 5, planes, tables, bn))
        out[f"{b}x{size}"] = row
        del frames, patches
        torch.cuda.empty_cache()
    return out


def main() -> None:
    for src, log in _build.build(["fpca_conv"]).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas", src, line.strip())
    dev = torch.device("cuda")
    tables = K.conv_tables(fit_bucket_model(n_pixels=75, device=dev), ADCConfig(), 75, dev)
    g = torch.Generator().manual_seed(0)
    out = {"src": sys.argv[1]}
    if sys.argv[2:] == ["--frames"]:
        out.update(frames_ab(dev, tables, g))
        print(json.dumps(out))
        return
    patches = torch.rand((147456, 75), generator=g).to(dev)
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
