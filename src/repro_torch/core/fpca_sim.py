"""Functional pieces of one FPCA first-layer convolution.

    image --binning--> photocurrents --windows--> bitline reads (pos & neg
    cycle per channel) --SS-ADC up/down + BN offset--> ReLU'd counts

Weights are split into positive and negative conductance planes; windows
and planes are flattened channel-major ``(c_i, n, n)`` so they line up.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.adc import ste_round
from repro_torch.core.curvefit import BucketCurvefitModel, predict_hard, predict_sigmoid
from repro_torch.core.mapping import FPCASpec

__all__ = ["WeightEncoding", "encode_weights", "extract_windows"]


@dataclasses.dataclass(frozen=True)
class WeightEncoding:
    """Float kernel -> NVM conductance-pair encoding (paper §3.2 / Fig. 2)."""

    n_levels: int = 16      # NVM programmable conductance levels (4-bit device)
    w_scale: float = 1.0    # |K| mapped to full conductance at this magnitude

    def quantize(self, w01: torch.Tensor, *, hard: bool = True) -> torch.Tensor:
        """Quantize normalised conductances to the device's discrete levels."""
        q = w01 * (self.n_levels - 1)
        q = torch.round(q) if hard else ste_round(q)
        return q / (self.n_levels - 1)


def encode_weights(
    kernel: torch.Tensor, spec: FPCASpec, enc: WeightEncoding, *, hard: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ``(c_o, k, k, c_i)`` float kernel into ``(w_pos, w_neg)``
    conductance planes, each ``(c_o, n*n*c_i)`` in [0, 1], zero-padded to the
    physical max kernel ``n`` (unused slots hold conductance 0) and
    flattened channel-major to match :func:`extract_windows`."""
    c_o, k, _, c_i = kernel.shape
    n = spec.max_kernel
    if k != spec.kernel or c_i != spec.in_channels:
        raise ValueError(f"kernel shape {tuple(kernel.shape)} inconsistent with spec {spec}")
    kernel = kernel.float()
    w01 = (kernel.abs() / enc.w_scale).clamp(0.0, 1.0)
    zero = torch.zeros_like(w01)
    w_pos = torch.where(kernel > 0, w01, zero)
    w_neg = torch.where(kernel < 0, w01, zero)

    def _layout(w: torch.Tensor) -> torch.Tensor:
        w = enc.quantize(w, hard=hard).permute(0, 3, 1, 2)      # (c_o, c_i, k, k)
        w = F.pad(w, (0, n - k, 0, n - k))                       # zero NVM slots
        return w.reshape(c_o, c_i * n * n)

    return _layout(w_pos), _layout(w_neg)


def extract_windows(image: torch.Tensor, spec: FPCASpec) -> torch.Tensor:
    """Image(s) -> photocurrent windows.

    ``(H, W, c_i)`` gives ``(h_o, w_o, c_i*n*n)``; a batch ``(B, H, W, c_i)``
    gives ``(B, h_o, w_o, c_i*n*n)``.  Applies pixel binning (average pool)
    and zero padding first; flattening is channel-major ``(c_i, n, n)``.
    """
    squeeze = image.ndim == 3
    if squeeze:
        image = image[None]
    if image.ndim != 4 or image.shape[-1] != spec.in_channels:
        raise ValueError(
            f"expected (H, W, {spec.in_channels}) or (B, H, W, {spec.in_channels}) "
            f"image, got {tuple(image.shape)}"
        )
    img = image.float()
    b = spec.binning
    if b > 1:
        B, h, w, c = img.shape
        img = img[:, : h // b * b, : w // b * b].reshape(B, h // b, b, w // b, b, c).mean((2, 4))
    n, s, p = spec.max_kernel, spec.stride, spec.padding
    if s == n and p == 0:
        # non-overlapping windows (the paper's energy-optimal stride): a pure
        # reshape, no gather
        B, h, w, c = img.shape
        h_o, w_o = h // n, w // n
        tiles = img[:, : h_o * n, : w_o * n].reshape(B, h_o, n, w_o, n, c)
        out = tiles.permute(0, 1, 3, 5, 2, 4).reshape(B, h_o, w_o, c * n * n)
    else:
        B = img.shape[0]
        cols = F.unfold(img.permute(0, 3, 1, 2), kernel_size=n, stride=s, padding=p)
        h_o = (img.shape[1] + 2 * p - n) // s + 1
        w_o = (img.shape[2] + 2 * p - n) // s + 1
        out = cols.reshape(B, -1, h_o, w_o).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def _analog_read(
    I: torch.Tensor, W: torch.Tensor, mode: str, model: BucketCurvefitModel
) -> torch.Tensor:
    """Batched bitline read of the calibrated bucket model: I ``(..., N)``,
    W ``(c_o, N)`` -> ``(..., c_o)``.  ``mode`` is ``"bucket_sigmoid"`` or
    ``"bucket_hard"``."""
    fn = {"bucket_sigmoid": predict_sigmoid, "bucket_hard": predict_hard}.get(mode)
    if fn is None:
        raise ValueError(f"unknown bucket mode {mode!r}")
    Ib = I[..., None, :]
    shape = Ib.shape[:-2] + W.shape
    return fn(model, Ib.expand(shape), W.expand(shape))
