"""Peripheral single-slope ADC model (paper §2).

The counter starts at the folded BatchNorm offset, counts **up** during the
positive-kernel cycle and **down** during the negative one; the final count
is clamped to ``[0, 2^b - 1]`` (the lower clamp is the ReLU).  Rounding is
``torch.round``: half to even, as ``jnp.round`` in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ADCConfig", "quantize_voltage", "updown_readout", "ste_round"]


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    bits: int = 8          # b_ADC (paper uses 8-bit activations)
    v_ref: float = 1.0     # full-scale ramp voltage

    @property
    def levels(self) -> int:
        return 2**self.bits

    @property
    def lsb(self) -> float:
        return self.v_ref / self.levels


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient (identity backward)."""
    return x + (torch.round(x) - x).detach()


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``x`` clamped to ``[lo, hi]``, its gradient included.
    ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose ties pass half the
    gradient at a bound; ``Tensor.clamp`` passes all of it.  Under the STEs
    a count of exactly 0 or ``2^b - 1`` is the common case, so where autograd
    records, the bounds are tensors and the tie rule is jax's.  Elsewhere
    (serving) ``clamp`` gives the same values in one kernel: the min/max form
    on every path cost 2-6% of the device time of a served request or
    segment tick (``chip_smoke.py``, H100 80GB HBM3 at 700 W)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.clamp(lo, hi)
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), torch.full_like(lo_t, hi))


def quantize_voltage(v: torch.Tensor, cfg: ADCConfig, *, hard: bool = True) -> torch.Tensor:
    """Single-slope conversion of a bitline voltage to a ramp count."""
    counts = v / cfg.lsb
    counts = torch.round(counts) if hard else ste_round(counts)
    return clip(counts, 0, cfg.levels - 1)


def updown_readout(
    v_pos: torch.Tensor,
    v_neg: torch.Tensor,
    cfg: ADCConfig,
    bn_offset_counts: torch.Tensor | float = 0.0,
    *,
    hard: bool = True,
) -> torch.Tensor:
    """count = clip(offset + Q(v_pos) - Q(v_neg), 0, 2^b - 1)."""
    up = quantize_voltage(v_pos, cfg, hard=hard)
    down = quantize_voltage(v_neg, cfg, hard=hard)
    count = bn_offset_counts + up - down
    return clip(count, 0, cfg.levels - 1)
