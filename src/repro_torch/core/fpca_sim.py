"""End-to-end functional simulator of one FPCA first-layer convolution.

    image --binning--> photocurrents --windows--> bitline reads (pos & neg
    cycle per channel) --SS-ADC up/down + BN offset--> ReLU'd counts

Weights are split into positive and negative conductance planes; windows
and planes are flattened channel-major ``(c_i, n, n)`` so they line up.

Three evaluation modes share one code path:

* ``"oracle"``         — fixed-point circuit solve (deployment ground truth);
* ``"bucket_hard"``    — the paper's step-function bucket select;
* ``"bucket_sigmoid"`` — the paper's differentiable single equation
  (trainable).

Execution backends (``fpca_forward(backend=...)``) resolve through the
:mod:`repro_torch.fpca.backends` registry:

* ``"reference"`` — the dense torch path in this module (every mode; the
  only differentiable backend, used for training and as the parity oracle);
* ``"cuda"`` / ``"basis"`` — the fused fpca kernel and its plain version
  (:func:`repro_torch.kernels.fpca_conv.ops.fpca_conv`): ``bucket_sigmoid``
  with hard ADC rounding only, i.e. deployment-mode serving of the
  calibrated sensor model.

Every function computes on its inputs' device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import mapping
from repro_torch.core.adc import ADCConfig, clip, ste_round, updown_readout
from repro_torch.core.curvefit import BucketCurvefitModel, predict_hard, predict_sigmoid
from repro_torch.core.device_models import CircuitParams, analog_dot_product
from repro_torch.core.mapping import FPCASpec
from repro_torch.device import resolve_device

__all__ = [
    "WeightEncoding",
    "encode_weights",
    "extract_windows",
    "fpca_forward",
    "calibrate_gain",
]

Mode = Literal["oracle", "bucket_hard", "bucket_sigmoid"]
# Backend names resolve through the repro_torch.fpca.backends registry; the
# Literal documents the built-ins, third-party registrations are equally valid.
Backend = Literal["reference", "cuda", "basis"]


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
    w01 = clip(kernel.abs() / enc.w_scale, 0.0, 1.0)
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
    b = spec.binning
    n, s, p = spec.max_kernel, spec.stride, spec.padding
    # binning averages in f32; otherwise frames stay in their dtype until
    # the patch matrix (one pass from bf16 frames, no f32 copy of them)
    img = image.float() if b > 1 or not (s == n and p == 0) else image
    if b > 1:
        B, h, w, c = img.shape
        img = img[:, : h // b * b, : w // b * b].reshape(B, h // b, b, w // b, b, c).mean((2, 4))
    if s == n and p == 0:
        # non-overlapping windows (the paper's energy-optimal stride): a pure
        # reshape, no gather
        B, h, w, c = img.shape
        h_o, w_o = h // n, w // n
        tiles = img[:, : h_o * n, : w_o * n].reshape(B, h_o, n, w_o, n, c)
        out = torch.empty((B, h_o, w_o, c * n * n), dtype=torch.float32, device=img.device)
        out.view(B, h_o, w_o, c, n, n).copy_(tiles.permute(0, 1, 3, 5, 2, 4))
    else:
        B = img.shape[0]
        cols = F.unfold(img.permute(0, 3, 1, 2), kernel_size=n, stride=s, padding=p)
        h_o = (img.shape[1] + 2 * p - n) // s + 1
        w_o = (img.shape[2] + 2 * p - n) // s + 1
        out = cols.reshape(B, -1, h_o, w_o).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def _analog_read(
    I: torch.Tensor,
    W: torch.Tensor,
    mode: Mode,
    circuit: CircuitParams,
    model: BucketCurvefitModel | None,
    n_active: int,
) -> torch.Tensor:
    """Batched bitline read: I ``(..., N)``, W ``(c_o, N)`` -> ``(..., c_o)``."""
    Ib = I[..., None, :]  # (..., 1, N) broadcast against channels
    shape = Ib.shape[:-2] + W.shape
    if mode == "oracle":
        return analog_dot_product(Ib.expand(shape), W, circuit, n_pixels=n_active)
    fn = {"bucket_sigmoid": predict_sigmoid, "bucket_hard": predict_hard}.get(mode)
    if fn is None:
        raise ValueError(f"unknown mode {mode!r}")
    if model is None:
        raise ValueError("bucket modes need a fitted BucketCurvefitModel")
    return fn(model, Ib.expand(shape), W.expand(shape))


def fpca_forward(
    image: torch.Tensor,
    kernel: torch.Tensor,
    spec: FPCASpec,
    *,
    circuit: CircuitParams | None = None,
    model: BucketCurvefitModel | None = None,
    adc: ADCConfig | None = None,
    enc: WeightEncoding | None = None,
    bn_offset_counts: torch.Tensor | float = 0.0,
    mode: Mode = "oracle",
    hard: bool = True,
    block_mask: np.ndarray | None = None,
    backend: Backend = "reference",
) -> dict[str, torch.Tensor]:
    """Simulate the FPCA frontend for one image or a batch of images, on
    the image's device.

    ``image`` is ``(H, W, c_i)`` or ``(B, H, W, c_i)``; ``counts`` in the
    returned dict follows with ``(h_o, w_o, c_o)`` or ``(B, h_o, w_o, c_o)``
    (integer SS-ADC output).

    ``backend="reference"`` (default) is the dense torch simulation, runs
    under autograd, and also returns the raw ``v_pos`` / ``v_neg`` bitline
    voltages.  ``backend="cuda"`` / ``"basis"`` dispatch deployment-mode
    evaluation to the fused fpca kernel (its plain version for ``"basis"``
    and for CPU tensors): one ``(B*h_o*w_o, N)`` patch matrix through a
    single call with the SS-ADC epilogue fused in, so only ``counts`` is
    returned.  The fused backends require ``mode="bucket_sigmoid"``,
    ``hard=True`` and a fitted ``model``.

    ``block_mask`` (region skipping, §3.4.5) is applied after the fact on
    the reference backend (every window still evaluated) and in the kernel
    on the fused backends: kept windows are compacted before the call.
    """
    circuit = circuit or CircuitParams()
    adc = adc or ADCConfig()
    enc = enc or WeightEncoding()
    # resolve through the pluggable backend registry; imported lazily, as
    # the registry package imports this module
    from repro_torch.fpca.backends import get_backend

    be = get_backend(backend)
    if not be.fused and be.name != "reference":
        # a registered non-fused third-party backend has no entry point
        # here: falling through to the built-in dense path would silently
        # serve reference-sim outputs under the third party's name
        raise ValueError(
            f"backend {be.name!r} is not servable through fpca_forward; "
            f"use repro.fpca.compile(program, backend={be.name!r}).run(images)"
        )
    if be.fused:
        warnings.warn(
            "fpca_forward(backend=...) fused serving is a deprecation shim; "
            "use repro.fpca.compile(program, backend=...).run(images) — the "
            "explicit executable handle with a held cache and "
            "reprogram-without-recompile",
            DeprecationWarning,
            stacklevel=2,
        )
        if mode != "bucket_sigmoid" or not hard:
            raise ValueError(
                f"backend={backend!r} serves the calibrated bucket model with hard "
                "ADC rounding (mode='bucket_sigmoid', hard=True); use "
                "backend='reference' for the circuit oracle or training"
            )
        if model is None:
            raise ValueError("fused backends need a fitted BucketCurvefitModel")
        if be.conv is None:
            raise ValueError(
                f"backend {be.name!r} registers no one-shot conv entry point; "
                f"serve it through repro.fpca.compile(program, "
                f"backend={be.name!r}).run(images)"
            )
        images = image if image.ndim == 4 else image[None]
        c_o = kernel.shape[0]
        bn = torch.as_tensor(bn_offset_counts, dtype=torch.float32, device=images.device)
        bn = bn.reshape(-1).expand(c_o)
        window_mask = None
        if block_mask is not None:
            keep = mapping.active_window_mask(spec, block_mask)
            window_mask = np.repeat(keep[None], images.shape[0], axis=0)
        counts = be.conv(
            images, kernel, model, spec=spec, adc=adc, enc=enc, bn_offset=bn,
            window_mask=window_mask,
        )
        if image.ndim == 3:
            counts = counts[0]
        return {"counts": counts}
    w_pos, w_neg = encode_weights(kernel, spec, enc, hard=hard)
    I = extract_windows(image, spec)                      # ([B,] h_o, w_o, N)
    n_active = spec.n_active_pixels
    v_pos = _analog_read(I, w_pos, mode, circuit, model, n_active)
    v_neg = _analog_read(I, w_neg, mode, circuit, model, n_active)
    counts = updown_readout(v_pos, v_neg, adc, bn_offset_counts, hard=hard)
    if block_mask is not None:
        keep = torch.as_tensor(mapping.active_window_mask(spec, block_mask), device=counts.device)
        counts = counts * keep[..., None]
    return {"counts": counts, "v_pos": v_pos, "v_neg": v_neg}


def calibrate_gain(
    spec: FPCASpec,
    *,
    circuit: CircuitParams | None = None,
    adc: ADCConfig | None = None,
    enc: WeightEncoding | None = None,
    n_samples: int = 2048,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[float, float]:
    """Fit ``ideal_conv ≈ gain * (v_pos - v_neg) + bias`` on random operating
    points: the digital-gain calibration a deployment runs once.

    The samples are numpy's ``default_rng(seed)`` draws; the circuit oracle
    runs in f32 on ``device`` (the card by default); the least squares runs
    in float64 numpy on the host.  Returns ``(gain, r2)``: ``acts = counts *
    lsb * gain`` then approximates the ideal (quantized-weight) convolution,
    and ``r2`` quantifies the paper's "fairly linear" claim (Fig. 7(c)/(f)).
    """
    circuit = circuit or CircuitParams()
    enc = enc or WeightEncoding()
    adc = adc or ADCConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = spec.n_active_pixels
    I = torch.as_tensor(rng.uniform(0, 1, (n_samples, N)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.uniform(0, 1, (n_samples, N)), dtype=torch.float32, device=dev)
    Wq = enc.quantize(W)
    v = analog_dot_product(I, Wq, circuit, n_pixels=N)
    ideal = (I * Wq).sum(dim=-1) * enc.w_scale
    A = np.stack([v.cpu().numpy(), np.ones(n_samples)], axis=1)
    (gain, bias), res, *_ = np.linalg.lstsq(A, ideal.cpu().numpy(), rcond=None)
    ss_tot = float(((ideal - ideal.mean()) ** 2).sum())
    r2 = 1.0 - float(res[0]) / ss_tot if len(res) else 1.0
    del bias
    return float(gain), float(r2)
