"""Where the fpca kernel's counts land 2 off its plain version at a 16-bit ADC.

    PYTHONPATH=src python tools/fpca_count_probe.py

On one CUDA card, for the inputs of ``tests/test_torch_gpu.py::_inputs``
(uniform random patches and weights) at M = 5,000 (C = 16, and its first 8
channels), M = 147,456 (C = 8) and M = 20,000 (C = 40), each of N = 75
pixels under a 16-bit ADC, it prints how far the tensor-core launch, the
SIMT design and the plain f32 version each lie from the plain version and
from the same math evaluated in float64 on the host (largest difference,
counts off by 1 or more and by 2 or more), whether the launch equals its
channel blocks of 8 launched alone, and the first counts where the
launch is 2 off the plain version.
"""

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.kernels.fpca_conv import kernel as K

_MM = ((1, 1), (1, 2), (2, 1))


def float64_counts(patches, planes, tables, bn):
    """The plain version's math in float64 on the host."""
    x = patches.double().cpu()
    p64 = {k: v.double().cpu() for k, v in planes.items()}
    xp = {1: x, 2: x * x, 3: x * x * x}
    rv = {a: xp[a].sum(1, keepdim=True) for a in (1, 2, 3)}
    mm = [{(a, b): xp[a] @ p64["w_pows"][p, b - 1] for (a, b) in _MM} for p in (0, 1)]
    return K.basis_epilogue(rv, mm, p64, tables, bn.cpu().double()).to(patches.device)


def spread(a, b) -> str:
    d = (a - b).abs()
    return f"max {float(d.max()):.0f}, >=1 {int((d >= 1).sum())}, >=2 {int((d >= 2).sum())} of {d.numel()}"


def main() -> None:
    dev = torch.device("cuda")
    model = fit_bucket_model(n_pixels=75, device=dev)
    # (M, channels launched, ADC bits, channels drawn): C = 8 of a 16-channel draw is its first block
    for m, c, bits, drawn in ((5000, 16, 16, 16), (5000, 8, 16, 16), (147456, 8, 16, 8), (20000, 40, 16, 40)):
        g = torch.Generator().manual_seed(m + 75 + drawn)
        patches = torch.rand((m, 75), generator=g).to(dev)
        w = torch.rand((75, drawn), generator=g).to(dev)[:, :c]
        bn = torch.randint(0, 30, (drawn,), generator=g).float().to(dev)[:c].contiguous()
        tables = K.conv_tables(model, ADCConfig(bits=bits), 75, dev)
        planes = K.weight_planes(w.contiguous(), w.roll(1, dims=1).contiguous(), tables)
        tc = K.fpca_conv_cuda(patches, planes, tables, bn)
        simt = torch.empty_like(tc)
        assert K._launch(patches, planes, tables, bn, None, simt, tensor_cores=False) == 0
        blocks = torch.cat([K.fpca_conv_cuda(patches, {k: v[..., lo:lo + 8].contiguous() for k, v in planes.items()},
                                             tables, bn[lo:lo + 8].contiguous()) for lo in range(0, c, 8)], -1)
        p32 = K.fpca_conv_basis(patches, planes, tables, bn)
        p64 = float64_counts(patches, planes, tables, bn)
        torch.cuda.synchronize()
        print(f"M={m} C={c} bits={bits}: launch == its blocks of 8: {torch.equal(tc, blocks)}")
        for name, a in (("tc", tc), ("simt", simt), ("plain32", p32)):
            print(f"  {name:8s} vs plain32: {spread(a, p32)}; vs float64: {spread(a, p64)}")
        for r, cc in ((tc - p32).abs() >= 2).nonzero()[:5].tolist():
            print(f"    at ({r},{cc}): tc {tc[r, cc].item()} simt {simt[r, cc].item()} "
                  f"plain32 {p32[r, cc].item()} float64 {p64[r, cc].item()}")


if __name__ == "__main__":
    main()
