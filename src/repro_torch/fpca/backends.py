"""Pluggable execution backends for the FPCA frontend.

Each :class:`Backend` names one way of evaluating a programmed array and
carries ``make_executable``: a factory returning a fresh
``(images, kernel, bn_offset[, window_mask]) -> counts`` closure whose
constant tables live (and die) with it.  :class:`repro_torch.fpca.CompiledFrontend`
holds those closures in its bounded LRU cache.

Built-ins:

* ``"cuda"``      — the hand-written CUDA kernel (``csrc/fpca_conv.cu``);
  the default on the card.  For CPU tensors it runs the kernel's plain
  version.
* ``"basis"``     — the kernel's math in plain PyTorch; the default on the
  host, and the one backend that lowers the int8 transfer LUT of
  ``precision="int8"`` model programs (``quant_transfer``).
* ``"reference"`` — the dense oracle (predict_sigmoid + updown_readout):
  every window evaluated, skipped ones zeroed after the fact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.adc import ADCConfig, updown_readout
from repro_torch.core.curvefit import BucketCurvefitModel
from repro_torch.core.fpca_sim import WeightEncoding, _analog_read, encode_weights, extract_windows
from repro_torch.core.mapping import FPCASpec
from repro_torch.kernels.fpca_conv.ops import make_fpca_conv_executable

__all__ = [
    "Backend",
    "register_backend",
    "get_backend",
    "available_backends",
    "default_backend_name",
]


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution backend.

    ``bucket_sensitive`` marks backends whose executables differ per
    region-skip row bucket; the dense oracle serves every bucket with one
    executable, so caches collapse its key.  ``quant_transfer`` marks
    backends whose ``make_executable`` takes ``transfer="int8"``; the others
    serve the f32 frontend under an int8 head.
    """

    name: str
    make_executable: Callable
    bucket_sensitive: bool = True
    quant_transfer: bool = False
    description: str = ""

    def make_model_executable(
        self,
        model_program,                      # repro_torch.fpca.FPCAModelProgram
        bucket_model: BucketCurvefitModel,
        *,
        m_bucket: int | None = None,
        device: torch.device,
    ) -> Callable:
        """A whole-model executable: this backend's frontend closure, then
        :meth:`FPCAModelProgram.apply_head`.  Signature
        ``(images, kernel, bn_offset, head_params[, window_mask]) -> (b,) +
        head_out_shape``.  A ``precision="int8"`` program on a
        :attr:`quant_transfer` backend also serves the int8 transfer."""
        kw = {}
        if self.quant_transfer and model_program.precision == "int8":
            kw["transfer"] = "int8"
        frontend = self.make_executable(
            bucket_model,
            spec=model_program.frontend.spec,
            adc=model_program.frontend.adc,
            enc=model_program.frontend.enc,
            m_bucket=m_bucket,
            device=device,
            **kw,
        )
        head = model_program.apply_head

        def run(images, kernel, bn_offset, head_params, *window_mask):
            return head(head_params, frontend(images, kernel, bn_offset, *window_mask))

        return run


_REGISTRY: dict[str, Backend] = {}


def register_backend(
    name: str,
    *,
    bucket_sensitive: bool = True,
    quant_transfer: bool = False,
    description: str = "",
    overwrite: bool = False,
) -> Callable[[Callable], Callable]:
    """Decorator registering an executable factory as backend ``name``.

    The factory has the signature
    ``factory(model, *, spec, adc, enc, m_bucket=None, device)`` and returns
    an ``(images, kernel, bn_offset) -> counts`` closure, taking a trailing
    ``window_mask`` when ``m_bucket`` is set.
    """

    def deco(make_executable: Callable) -> Callable:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = Backend(
            name=name,
            make_executable=make_executable,
            bucket_sensitive=bucket_sensitive,
            quant_transfer=quant_transfer,
            description=description,
        )
        return make_executable

    return deco


def get_backend(name: str | Backend) -> Backend:
    """Resolve a backend by name (raises ``ValueError`` listing the options)."""
    if isinstance(name, Backend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: {available_backends()}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def default_backend_name(device: torch.device) -> str:
    """The CUDA kernel on the card, its plain version on the host."""
    return "cuda" if device.type == "cuda" else "basis"


def _fused_factory(impl: str) -> Callable:
    def make_executable(
        model: BucketCurvefitModel,
        *,
        spec: FPCASpec,
        adc: ADCConfig | None = None,
        enc: WeightEncoding | None = None,
        m_bucket: int | None = None,
        device: torch.device,
        transfer: str = "f32",
    ) -> Callable:
        return make_fpca_conv_executable(
            model, spec=spec, adc=adc, enc=enc, impl=impl, m_bucket=m_bucket, device=device,
            transfer=transfer,
        )

    return make_executable


register_backend(
    "cuda",
    description="hand-written CUDA kernel for sm_90a (plain PyTorch version on CPU tensors)",
)(_fused_factory("cuda"))

register_backend(
    "basis",
    quant_transfer=True,
    description="the kernel's basis-bank math in plain PyTorch",
)(_fused_factory("basis"))


@register_backend(
    "reference",
    bucket_sensitive=False,   # dense eval + post-hoc mask: one executable serves all buckets
    description="dense oracle (parity reference; evaluates every window)",
)
def _reference_executable(
    model: BucketCurvefitModel,
    *,
    spec: FPCASpec,
    adc: ADCConfig | None = None,
    enc: WeightEncoding | None = None,
    m_bucket: int | None = None,
    device: torch.device,
) -> Callable:
    """Dense-reference executable with the fused backends' semantics
    (calibrated bucket-sigmoid model, hard ADC); the masked variant zeroes
    skipped windows after evaluating them all."""
    del device   # computes on the inputs' device; holds no device state
    adc = adc or ADCConfig()
    enc = enc or WeightEncoding()

    def _counts(images, kernel, bn_offset):
        w_pos, w_neg = encode_weights(kernel, spec, enc, hard=True)
        I = extract_windows(images, spec)
        v_pos = _analog_read(I, w_pos, "bucket_sigmoid", model)
        v_neg = _analog_read(I, w_neg, "bucket_sigmoid", model)
        return updown_readout(v_pos, v_neg, adc, bn_offset, hard=True)

    def run(images, kernel, bn_offset, window_mask=None):
        if (window_mask is None) != (m_bucket is None):
            raise ValueError("pass window_mask exactly when the executable has an m_bucket")
        counts = _counts(images, kernel, bn_offset)
        if window_mask is None:
            return counts
        keep = window_mask.reshape(counts.shape[:-1])
        return counts * keep[..., None].float()

    return run
