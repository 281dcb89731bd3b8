"""Content-driven block saliency for region skipping (paper §3.4.5).

A cheap host-side pass that picks the ``skip_block``-sized blocks whose
content is worth reading and hands the keep grid to the frontend.  For
streaming workloads the temporal delta gate
(:mod:`repro_torch.serving.streaming`) supersedes it: saliency needs the
full frame it tries to avoid reading, the delta gate only the previous
frame's block statistics.  Saliency remains the tool for single-shot
inference where a low-resolution preview exposure is available.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core import mapping

__all__ = ["saliency_mask"]


def saliency_mask(image: np.ndarray, spec: mapping.FPCASpec, keep_frac: float = 0.4) -> np.ndarray:
    """Block-wise brightness variance -> keep the liveliest blocks.

    Works on the effective (binned) frame, so the grid matches the
    periphery SRAM layout :func:`repro_torch.core.mapping.active_window_mask`
    expects: boolean ``(ceil(eff_h/B), ceil(eff_w/B))``, True = keep.
    """
    if not 0.0 < keep_frac <= 1.0:
        raise ValueError("keep_frac must be in (0, 1]")
    img = np.asarray(image, np.float32)
    bf = spec.binning
    if bf > 1:
        h, w, c = img.shape
        img = img[: h // bf * bf, : w // bf * bf].reshape(h // bf, bf, w // bf, bf, c).mean((1, 3))
    b = spec.skip_block
    h, w, c = img.shape
    bh, bw = math.ceil(h / b), math.ceil(w / b)
    var = np.zeros((bh, bw), np.float32)
    for r in range(bh):
        for cc in range(bw):
            var[r, cc] = img[r * b : (r + 1) * b, cc * b : (cc + 1) * b].var()
    k = max(1, int(keep_frac * var.size))
    thresh = np.partition(var.ravel(), -k)[-k]
    return var >= thresh
