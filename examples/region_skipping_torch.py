"""Region skipping (paper §3.4.5), in PyTorch: content-driven block masks
cut frontend energy while preserving the activations that matter.

    PYTHONPATH=src python examples/region_skipping_torch.py [--device cpu]

The torch twin of ``examples/region_skipping.py``; runs on the CUDA card
unless ``--device`` names another, serving through the backend the device
takes (the fpca kernel on the card, its plain version on the host).

Pipeline: a cheap binned-brightness saliency pass
(:func:`repro_torch.serving.saliency.saliency_mask`) picks the 8x8 blocks
worth reading; the mask is pushed *into* the fused kernel — kept windows
are compacted before the kernel runs, so skipped windows never execute.
The dense reference simulation is the oracle on the kept region: on the
host the plain version equals it bit for bit; the kernel on the card may
put a count one off on a few windows (its products sum in another order),
and the line then says how many.  ``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import fpca
from repro_torch.core import analysis, mapping
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.fpca_sim import fpca_forward
from repro_torch.data.pipeline import SyntheticVWW
from repro_torch.device import resolve_device
from repro_torch.fpca.backends import default_backend_name
from repro_torch.serving.saliency import saliency_mask

SPEC = mapping.FPCASpec(
    image_h=64, image_w=64, out_channels=8, kernel=5, stride=5, skip_block=8
)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    circuit = CircuitParams()
    model = fit_bucket_model(circuit, device=dev)
    data = SyntheticVWW((64, 64))
    batch = data.batch_at(0, 4)

    e_full = analysis.frontend_energy(SPEC)
    print(f"full frame: N_C={e_full['n_cycles']} E={e_full['e_total']*1e6:.2f} uJ")

    # one compiled handle serves every masked frame (the mask is runtime
    # state: it never recompiles, only re-buckets)
    kernel = _kernel(dev)
    fe = fpca.compile(
        fpca.FPCAProgram(spec=SPEC, circuit=circuit), backend=default_backend_name(dev),
        device=dev, weights=kernel, model=model,
    )

    out: dict = {"images": []}
    for i, img in enumerate(batch["images"]):
        mask = saliency_mask(img, SPEC)
        e_skip = analysis.frontend_energy(SPEC, block_mask=mask)
        x = torch.as_tensor(img, device=dev)
        # dense reference: every window evaluated, skipped region zeroed
        full = fpca_forward(x, kernel, SPEC, circuit=circuit, model=model, mode="bucket_sigmoid")["counts"]
        # fused serving path: the mask compacts the window list in the kernel call
        skip = fe.run(x, block_mask=mask)
        active = torch.as_tensor(mapping.active_window_mask(SPEC, mask), device=dev)
        diff = (full[active] - skip[active]).abs()
        same = bool((diff == 0).all())
        zeroed = bool((skip[~active] == 0).all())
        n_win = active.numel()
        kept = int(active.sum())
        off = "" if same else (f" (max|Δcount| {float(diff.max()):.0f} on {float((diff > 0).float().mean()):.2e}"
                               f" of kept counts)")
        print(
            f"image {i}: kept {mask.mean()*100:.0f}% blocks -> "
            f"windows {kept}/{n_win} executed, "
            f"N_C {e_skip['n_cycles']} ({e_skip['n_cycles']/e_full['n_cycles']:.2f}x), "
            f"E {e_skip['e_total']*1e6:.2f} uJ ({e_skip['e_total']/e_full['e_total']:.2f}x), "
            f"kept-region identical={same}, skipped zeroed={zeroed}{off}"
        )
        out["images"].append({
            "kept_blocks": float(mask.mean()), "kept_windows": kept, "windows": n_win,
            "n_cycles": e_skip["n_cycles"], "e_total": e_skip["e_total"], "identical": same,
            "zeroed": zeroed, "max_count_diff": float(diff.max()) if diff.numel() else 0.0,
            "counts": skip.cpu().numpy(),
        })
    out["full_n_cycles"], out["full_e_total"] = e_full["n_cycles"], e_full["e_total"]
    return out


def _kernel(device: torch.device) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return (torch.randn((8, 5, 5, 3), generator=g) * 0.2).to(device)


if __name__ == "__main__":
    main()
