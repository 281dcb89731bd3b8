"""Temporal delta-gate math, shared by the per-tick loop and the segment.

The streaming stack runs the gate state machine in two places: the per-tick
host loop (:class:`repro_torch.serving.streaming.StreamSession`) and the
segment executor (:meth:`repro_torch.fpca.CompiledFrontend.run_segment`,
K ticks replayed as one CUDA graph on the card).  Their contract is
bit-identity, tick for tick, and the fragile part is the comparison
``block_delta > threshold``: a one-ulp difference in a block mean flips a
keep/skip decision.  So the gate numerics are defined once, as the torch
ops here, and both paths evaluate them on the handle's device: a mean
taken on the host and one taken on the card may differ by an ulp.

Everything here depends only on :mod:`repro_torch.core.mapping`.

State machine (the same as ``streaming._GateState.step``):

* block ages start at ``hysteresis + 1`` (everything stale);
* a block's age resets to 0 when its mean |Δ| exceeds the threshold, else
  increments, but only once a previous frame exists;
* a tick is a keyframe on the first frame, then whenever
  ``keyframe_interval > 0`` and ``frame_idx % keyframe_interval == 0``;
* keep = everything on a keyframe, else ``age <= hysteresis``; keyframes do
  not reset ages.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.mapping import FPCASpec, output_dims

__all__ = [
    "GateCarry",
    "block_grid",
    "effective_frame",
    "block_reduce_mean",
    "block_delta",
    "window_mask_from_blocks",
    "gate_tick",
    "init_gate_carry",
    "host_gate_kernels",
]


class GateCarry(NamedTuple):
    """Delta-gate state on the device (the segment carry's gate slice).

    ``has_prev`` gates the age update and forces the first-frame keyframe;
    ``prev_eff`` is the previous effective (binned grayscale) frame; ``age``
    counts frames since each block last changed (int32); ``frame_idx``
    drives the keyframe cadence.
    """

    has_prev: torch.Tensor   # () bool
    prev_eff: torch.Tensor   # (eff_h, eff_w) float32
    age: torch.Tensor        # (bh, bw) int32
    frame_idx: torch.Tensor  # () int32


def block_grid(spec: FPCASpec) -> tuple[int, int]:
    """Shape of the per-block keep/age grids (periphery SRAM geometry)."""
    b = spec.skip_block
    return math.ceil(spec.eff_h / b), math.ceil(spec.eff_w / b)


def _mean_in_order(xs: list[torch.Tensor]) -> torch.Tensor:
    """Mean of equally shaped tensors summed left to right, times the
    float32 reciprocal of the count: the order and rounding of the
    reference's reductions, so effective frames agree bit for bit."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc * float(np.float32(1.0 / len(xs)))


def effective_frame(frame: torch.Tensor, spec: FPCASpec) -> torch.Tensor:
    """Frame(s) ``(..., H, W, c_i)`` as the pixel array sees them: binned
    (average pool) grayscale ``(..., eff_h, eff_w)``."""
    img = frame.float()
    img = _mean_in_order([img[..., c] for c in range(img.shape[-1])])
    b = spec.binning
    if b > 1:
        h, w = img.shape[-2:]
        tiles = img[..., : h // b * b, : w // b * b].reshape(img.shape[:-2] + (h // b, b, w // b, b))
        img = _mean_in_order([tiles[..., i, :, j] for i in range(b) for j in range(b)])
    return img


@functools.lru_cache(maxsize=64)
def _block_counts(h: int, w: int, block: int, device: torch.device) -> torch.Tensor:
    """Real pixels per tile, on ``device`` (built once, before any capture:
    a host-to-device copy cannot be recorded into a CUDA graph)."""
    bh, bw = math.ceil(h / block), math.ceil(w / block)
    ones = np.zeros((bh * block, bw * block), np.float32)
    ones[:h, :w] = 1.0
    return torch.as_tensor(ones.reshape(bh, block, bw, block).sum((1, 3)), device=device)


def block_reduce_mean(x: torch.Tensor, block: int) -> torch.Tensor:
    """Mean over ``block x block`` tiles of ``(..., h, w)`` (ragged edge
    tiles average their real pixels only), shape ``(..., ceil(h/b),
    ceil(w/b))``."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    bh, bw = math.ceil(h / block), math.ceil(w / block)
    padded = torch.nn.functional.pad(x, (0, bw * block - w, 0, bh * block - h))
    sums = padded.reshape(lead + (bh, block, bw, block)).sum((-3, -1))
    return sums / _block_counts(h, w, block, x.device)


def block_delta(prev_eff: torch.Tensor, cur_eff: torch.Tensor, spec: FPCASpec) -> torch.Tensor:
    """Mean absolute per-block change between two effective frames."""
    return block_reduce_mean((cur_eff - prev_eff).abs(), spec.skip_block)


@functools.lru_cache(maxsize=64)
def _window_gather(spec: FPCASpec, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each window and each pixel of its ``n x n`` footprint, the flat
    index of the block that pixel lies in, and whether the pixel lies inside
    the effective frame (footprints that run past it read as not kept); on
    ``device``, built once."""
    h_o, w_o = output_dims(spec)
    n, s, b = spec.max_kernel, spec.stride, spec.skip_block
    _, bw = block_grid(spec)
    rows = np.arange(h_o)[:, None] * s + np.arange(n)[None, :]     # (h_o, n)
    cols = np.arange(w_o)[:, None] * s + np.arange(n)[None, :]     # (w_o, n)
    r = rows[:, None, :, None]
    c = cols[None, :, None, :]
    valid = (r < spec.eff_h) & (c < spec.eff_w)                     # (h_o, w_o, n, n)
    idx = np.where(valid, (r // b) * bw + c // b, 0)
    return (torch.as_tensor(idx.reshape(h_o * w_o, n * n), dtype=torch.long, device=device),
            torch.as_tensor(valid.reshape(h_o * w_o, n * n), device=device))


def window_mask_from_blocks(block_keep: torch.Tensor, spec: FPCASpec) -> torch.Tensor:
    """Device twin of :func:`repro_torch.core.mapping.active_window_mask`:
    a window executes iff any of its pixels lies in a kept block; footprints
    that run past the effective frame read as not kept.  The gather indices
    and the validity mask are built once per spec.  Returns ``(h_o, w_o)``
    bool."""
    idx, valid = _window_gather(spec, block_keep.device)
    return (block_keep.reshape(-1)[idx] & valid).any(-1).reshape(output_dims(spec))


def init_gate_carry(spec: FPCASpec, hysteresis: int, device: torch.device) -> GateCarry:
    """Fresh gate state: no previous frame, every block stale."""
    bh, bw = block_grid(spec)
    return GateCarry(
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        prev_eff=torch.zeros((spec.eff_h, spec.eff_w), device=device),
        age=torch.full((bh, bw), int(hysteresis) + 1, dtype=torch.int32, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def gate_tick(
    spec: FPCASpec,
    carry: GateCarry,
    cur_eff: torch.Tensor,
    threshold: torch.Tensor,
    hysteresis: torch.Tensor,
    keyframe_interval: torch.Tensor,
) -> tuple[GateCarry, torch.Tensor, torch.Tensor]:
    """One delta-gate transition.  The knobs enter as device tensors
    (``threshold`` float32, the others int32), so a threshold servo step or
    a cadence change is data, not a new executable.

    Returns ``(new_carry, keep_blocks (bh, bw) bool, keyframe () bool)``.
    """
    delta = block_delta(carry.prev_eff, cur_eff, spec)
    changed = delta > threshold
    age = torch.where(
        carry.has_prev,
        torch.where(changed, torch.zeros_like(carry.age), carry.age + 1),
        carry.age,
    )
    ki = keyframe_interval
    keyframe = (~carry.has_prev) | ((ki > 0) & (torch.remainder(carry.frame_idx, ki.clamp(min=1)) == 0))
    keep = keyframe | (age <= hysteresis)
    new_carry = GateCarry(
        has_prev=torch.ones_like(carry.has_prev),
        prev_eff=cur_eff,
        age=age,
        frame_idx=carry.frame_idx + 1,
    )
    return new_carry, keep, keyframe


class HostGateKernels(NamedTuple):
    """The gate numerics for the per-tick loop, on one device: the same
    torch ops the segment body runs, so both paths compare identical float32
    bits.  ``step`` computes the effective frame and the block deltas in one
    call; ``step_batch`` is its stacked twin for a group of streams (the
    per-row math is elementwise or a reduction over the row's own pixels,
    so batched and solo decisions agree bit for bit)."""

    eff: Callable         # frame -> effective frame
    delta: Callable       # (prev_eff, cur_eff) -> block |Δ| grid
    step: Callable        # (prev_eff, frame) -> (cur_eff, block |Δ| grid)
    step_batch: Callable  # (n, ...) stacked twin of ``step``


@functools.lru_cache(maxsize=None)
def host_gate_kernels(spec: FPCASpec, device: torch.device) -> HostGateKernels:
    """The per-tick gate functions for ``spec`` on ``device``; inputs may be
    numpy arrays or tensors, outputs are tensors on ``device``."""

    def _on(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def eff(frame):
        return effective_frame(_on(frame), spec)

    def delta(prev, cur):
        return block_delta(_on(prev), _on(cur), spec)

    def step(prev_eff, frame):
        cur = effective_frame(_on(frame), spec)
        return cur, block_delta(_on(prev_eff), cur, spec)

    return HostGateKernels(eff, delta, step, step)
