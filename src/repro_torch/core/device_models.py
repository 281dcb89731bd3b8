"""Circuit oracle for the FPCA pixel array (the SPICE stand-in the bucket
curvefit is fitted against).

The coupled bitline output is the fixed point of

    V = v_sat * tanh( (1 - lam * V / v_sat) * sum_j g(I_j, W_j) / (N * s0) )

solved with ``fp_iters`` fixed-point iterations in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["CircuitParams", "pixel_drive", "analog_dot_product", "analog_dot_product_from_drive"]


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """Device/circuit constants for the FPCA analog oracle."""

    v_sat: float = 1.0          # bitline supply clamp [V]
    s0: float = 0.37            # per-pixel drive normalisation
    drive_a: float = 0.15       # I^2 W curvature (photocurrent compression)
    drive_b: float = -0.10      # I W^2 curvature (NVM I-V bowing)
    drive_c: float = 0.25       # soft compression of the I*W product
    coupling: float = 0.15      # bitline -> pixel operating-point feedback
    kappa_r: float = 0.012      # metal-line degradation per mm per unit drive
    r_metal_mm: float = 0.0     # weight-die <-> pixel-die metal length [mm]
    fp_iters: int = 8           # fixed-point iterations (contracting; 8 >> enough)

    def replace(self, **kw: Any) -> "CircuitParams":
        return dataclasses.replace(self, **kw)


def pixel_drive(I: torch.Tensor, W: torch.Tensor, params: CircuitParams) -> torch.Tensor:
    """Per-pixel bitline drive ``g(I, W)`` (elementwise)."""
    I = I.float()
    W = W.float()
    iw = I * W
    num = iw + params.drive_a * (I * iw) + params.drive_b * (W * iw)
    g = num / (1.0 + params.drive_c * iw)
    # metal-line series resistance: larger drive -> larger IR drop
    return g / (1.0 + params.kappa_r * params.r_metal_mm * g)


def analog_dot_product_from_drive(
    g: torch.Tensor, n_pixels: int, params: CircuitParams
) -> torch.Tensor:
    """Bitline voltage given per-pixel drives ``g`` summed over the last axis.

    ``n_pixels`` is the number of *activated* pixels, a schedule constant
    (padded zero-weight slots still count as activated pixels).
    """
    s = g.sum(dim=-1)
    denom = n_pixels * params.s0
    v = params.v_sat * torch.tanh(s / denom)  # uncoupled initial guess
    for _ in range(params.fp_iters):
        eff = (1.0 - params.coupling * v / params.v_sat) * s
        v = params.v_sat * torch.tanh(eff / denom)
    return v


def analog_dot_product(
    I: torch.Tensor, W: torch.Tensor, params: CircuitParams, n_pixels: int | None = None
) -> torch.Tensor:
    """Analog convolution output for one bitline read cycle: ``I (..., N)``
    and ``W`` broadcastable to it -> bitline voltage ``(...,)``."""
    I = I.float()
    W = torch.broadcast_to(W.float(), I.shape)
    n = I.shape[-1] if n_pixels is None else n_pixels
    return analog_dot_product_from_drive(pixel_drive(I, W, params), n, params)
