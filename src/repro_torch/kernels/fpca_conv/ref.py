"""Dense oracle for the fpca_conv kernel.

Built on :func:`repro_torch.core.curvefit.predict_sigmoid` and
:func:`repro_torch.core.adc.updown_readout` rather than the basis-expanded
form, so a bug in the kernel's algebra cannot hide in its own oracle.

Layout contract (shared with the kernel):
  patches  (M, N)  — im2col windows (photocurrents);
  w_pos/w_neg (N, C) — per-output-channel NVM conductance planes;
  mask     (N,)    — 1.0 for real pixel slots, 0.0 for padding.
"""

from __future__ import annotations

import torch

from repro_torch.core.adc import ADCConfig, updown_readout
from repro_torch.core.curvefit import BucketCurvefitModel, predict_sigmoid

__all__ = ["fpca_conv_ref"]


def _read(
    model: BucketCurvefitModel, patches: torch.Tensor, w: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Bitline voltages, shape (M, C)."""
    I = patches[:, None, :] * mask
    W = (w.T * mask)[None, :, :]
    M, C, N = I.shape[0], W.shape[1], I.shape[-1]
    # padding would bias the step-1 mean, so evaluate on the real slots only
    n_real = int(mask.sum())
    return predict_sigmoid(model, I.expand(M, C, N)[..., :n_real], W.expand(M, C, N)[..., :n_real])


def fpca_conv_ref(
    patches: torch.Tensor,
    w_pos: torch.Tensor,
    w_neg: torch.Tensor,
    model: BucketCurvefitModel,
    adc: ADCConfig,
    bn_offset: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference FPCA analog convolution: counts, shape (M, C)."""
    patches = patches.float()
    if mask is None:
        mask = torch.ones(patches.shape[1], device=patches.device)
    v_pos = _read(model, patches, w_pos.float(), mask)
    v_neg = _read(model, patches, w_neg.float(), mask)
    return updown_readout(v_pos, v_neg, adc, bn_offset, hard=True)
