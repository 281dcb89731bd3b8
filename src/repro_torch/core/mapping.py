"""FPCA spec, output geometry and cycle schedule (paper §3.3--§3.4), pure
numpy.

The physical kernel footprint is always the max ``n x n``: smaller logical
kernels are written as zero weights (paper §3.4.1), so the output grid
(Eq. 8) is computed with ``n``, not the logical ``k``.  Windows computed in
the same cycle share a ``ColP`` phase and are spaced ``lcm(S, n)`` pixel
columns apart, giving ``lcm(S, n) / S`` horizontal phases per output row:
Eq. 1, ``N_C = 2 * h_o * c_o * lcm(S, n) / S``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

__all__ = [
    "FPCASpec",
    "Cycle",
    "output_dims",
    "n_cycles",
    "schedule",
    "active_window_mask",
    "n_cycles_with_skipping",
]


@dataclasses.dataclass(frozen=True)
class FPCASpec:
    """Static configuration of one FPCA first-layer convolution."""

    image_h: int
    image_w: int
    out_channels: int
    kernel: int                 # logical kernel size k (k <= max_kernel)
    stride: int
    max_kernel: int = 5         # physical n (weight-die provisioning)
    in_channels: int = 3        # RGB planes, processed concurrently (§3.2)
    padding: int = 0
    binning: int = 1            # pixel binning factor (Fig. 9(b))
    skip_block: int = 8         # region-skipping block granularity (§3.4.5)

    def __post_init__(self) -> None:
        if self.kernel > self.max_kernel:
            raise ValueError(f"kernel {self.kernel} exceeds max_kernel {self.max_kernel}")
        if not (1 <= self.stride <= self.max_kernel):
            raise ValueError("stride must be in [1, max_kernel] (paper §3.4.3)")

    @property
    def eff_h(self) -> int:
        return self.image_h // self.binning

    @property
    def eff_w(self) -> int:
        return self.image_w // self.binning

    @property
    def horizontal_phases(self) -> int:
        """lcm(S, n) / S: ColP phases needed to cover one output row."""
        return math.lcm(self.stride, self.max_kernel) // self.stride

    @property
    def n_active_pixels(self) -> int:
        """Pixels activated per window read — always the full n*n*in_ch region."""
        return self.max_kernel * self.max_kernel * self.in_channels

    @property
    def weights_per_column(self) -> int:
        """NVM devices per pixel column in the weight die (§3.2)."""
        return 2 * self.max_kernel**2 * self.in_channels * self.out_channels


def output_dims(spec: FPCASpec) -> tuple[int, int]:
    """Eq. 8 with the *physical* kernel n (zero-padded logical kernels)."""
    n, s, p = spec.max_kernel, spec.stride, spec.padding
    h_o = (spec.eff_h - n + 2 * p) // s + 1
    w_o = (spec.eff_w - n + 2 * p) // s + 1
    if h_o <= 0 or w_o <= 0:
        raise ValueError("image smaller than physical kernel footprint")
    return h_o, w_o


def n_cycles(spec: FPCASpec) -> int:
    """Eq. 1: ``N_C = 2 * h_o * c_o * lcm(S, n) / S``."""
    h_o, _ = output_dims(spec)
    return 2 * h_o * spec.out_channels * spec.horizontal_phases


@dataclasses.dataclass(frozen=True)
class Cycle:
    """One read cycle of the rolling-shutter convolution schedule."""

    sign: int                   # +1: CH_i phase, -1: CH_i_bar phase
    channel: int                # output channel (CH line index)
    out_row: int                # output row r (RS group)
    phase: int                  # ColP phase p in [0, lcm(S,n)/S)
    window_cols: np.ndarray     # output-column indices computed in parallel

    stride: int = 1
    max_kernel: int = 5

    @property
    def colp_line(self) -> int:
        """ColP line pulled up in this cycle: which kernel column is mapped
        onto the first pixel column of each window group (§3.4.3)."""
        return (self.phase * self.stride) % self.max_kernel


def schedule(spec: FPCASpec) -> Iterator[Cycle]:
    """Yield the full cycle schedule; ``len(list(...)) == n_cycles(spec)``.

    Parallel windows of a cycle: output columns ``w`` whose horizontal start
    ``x = w * S`` satisfies ``x ≡ p*S (mod lcm(S, n))``; their ``n``-wide
    column groups are disjoint, so they can share the cycle (§3.4.3).
    """
    h_o, w_o = output_dims(spec)
    n, s = spec.max_kernel, spec.stride
    period = math.lcm(s, n)
    all_cols = np.arange(w_o)
    for channel in range(spec.out_channels):
        for out_row in range(h_o):
            for phase in range(spec.horizontal_phases):
                cols = all_cols[(all_cols * s) % period == phase * s]
                for sign in (+1, -1):
                    yield Cycle(
                        sign=sign, channel=channel, out_row=out_row, phase=phase,
                        window_cols=cols, stride=s, max_kernel=n,
                    )


def active_window_mask(spec: FPCASpec, block_mask: np.ndarray | None) -> np.ndarray:
    """Region skipping (§3.4.5): which output windows actually execute.

    ``block_mask`` is the per-block keep grid, shape ``(ceil(H/B), ceil(W/B))``
    booleans (True = keep).  A window executes iff *any* of its pixels lies
    in a kept block.  Returns a boolean ``(h_o, w_o)`` mask.
    """
    h_o, w_o = output_dims(spec)
    if block_mask is None:
        return np.ones((h_o, w_o), dtype=bool)
    b = spec.skip_block
    exp_h, exp_w = math.ceil(spec.eff_h / b), math.ceil(spec.eff_w / b)
    if block_mask.shape != (exp_h, exp_w):
        raise ValueError(f"block_mask shape {block_mask.shape} != {(exp_h, exp_w)}")
    pixel_keep = np.kron(block_mask, np.ones((b, b), dtype=bool))[: spec.eff_h, : spec.eff_w]
    n, s = spec.max_kernel, spec.stride
    if (h_o - 1) * s + n <= spec.eff_h and (w_o - 1) * s + n <= spec.eff_w:
        # no padding: every window footprint is in-bounds — vectorised form
        windows = np.lib.stride_tricks.sliding_window_view(pixel_keep, (n, n))
        return windows[::s, ::s].any(axis=(2, 3))[:h_o, :w_o]
    mask = np.zeros((h_o, w_o), dtype=bool)
    for r in range(h_o):
        for c in range(w_o):
            mask[r, c] = pixel_keep[r * s : r * s + n, c * s : c * s + n].any()
    return mask


def n_cycles_with_skipping(spec: FPCASpec, block_mask: np.ndarray | None) -> int:
    """Executed cycles under region skipping: a cycle fires iff it contains
    at least one active window (the RS/SW gating is row/phase-granular)."""
    if block_mask is None:
        return n_cycles(spec)
    mask = active_window_mask(spec, block_mask)
    h_o, w_o = mask.shape
    s = spec.stride
    period = math.lcm(s, spec.max_kernel)
    executed_row_phases = 0
    all_cols = np.arange(w_o)
    for r in range(h_o):
        for phase in range(spec.horizontal_phases):
            cols = all_cols[(all_cols * s) % period == phase * s]
            if mask[r, cols].any():
                executed_row_phases += 1
    return 2 * spec.out_channels * executed_row_phases
