"""Trainable FPCA frontend layer: the paper's technique as a framework
feature.

``FPCAFrontend`` is a first-conv layer: training runs through the paper's
differentiable sigmoid bucket-select model (with STEs through the NVM level
quantiser and the SS-ADC), deployment evaluates through the circuit oracle
or the fpca kernel.  The gap between the two is the hardware/algorithm
co-design story: ``examples/train_fpca_cnn_torch.py`` shows that a network
trained through the bucket model keeps its accuracy when evaluated on the
oracle, while a naively trained network (ideal conv) degrades.

The layer is functional, like the rest of the FPCA side (``compile(weights=,
bn_offset=, head_params=)``): ``init`` returns a parameter dict and
``apply`` takes one, so it is not an ``nn.Module`` (whose ``apply(fn)``
means something else).  It is configured by a
:class:`repro_torch.fpca.FPCAProgram`; the former ``FPCAFrontendConfig``
name is a deprecated alias of it, kept importable from here.
"""

from __future__ import annotations

import math
import warnings
from typing import Any

import torch

from repro_torch.core.curvefit import BucketCurvefitModel, fit_bucket_model
from repro_torch.core.fpca_sim import calibrate_gain, fpca_forward
from repro_torch.core.mapping import output_dims
from repro_torch.device import resolve_device

__all__ = ["FPCAFrontendConfig", "FPCAFrontend"]


def __getattr__(name: str) -> Any:
    if name == "FPCAFrontendConfig":
        warnings.warn(
            "FPCAFrontendConfig is deprecated; use repro.fpca.FPCAProgram "
            "(same fields: spec, circuit, adc, enc)",
            DeprecationWarning,
            stacklevel=2,
        )
        # imported here: repro_torch.fpca imports this package
        from repro_torch.fpca.program import FPCAProgram

        return FPCAProgram
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class FPCAFrontend:
    """Functional layer: ``init(generator) -> params``, ``apply(params, x) -> y``.

    ``config`` is a :class:`repro_torch.fpca.FPCAProgram` (``spec`` /
    ``circuit`` / ``adc`` / ``enc`` are the fields this layer reads).  The
    layer lives on ``device`` (the card unless the caller names another):
    its calibration runs there and ``init`` puts the parameters there.
    Without ``model`` it fits a bucket model for the spec (seconds).
    """

    def __init__(
        self,
        config: Any,
        model: BucketCurvefitModel | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.model = model or fit_bucket_model(
            config.circuit, n_pixels=config.spec.n_active_pixels, device=self.device
        )
        gain, r2 = calibrate_gain(
            config.spec, circuit=config.circuit, adc=config.adc, enc=config.enc, device=self.device
        )
        self.gain = gain
        self.calibration_r2 = r2

    @property
    def out_shape(self) -> tuple[int, int, int]:
        h_o, w_o = output_dims(self.config.spec)
        return (h_o, w_o, self.config.spec.out_channels)

    def init(self, generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """``{"kernel": (c_o, k, k, c_i), "bn_offset": (c_o,)}``, f32 on the
        layer's device; the kernel is drawn on the host from ``generator``,
        so one seed gives the same weights on every device."""
        s = self.config.spec
        k = s.kernel
        fan_in = k * k * s.in_channels
        kernel = torch.randn((s.out_channels, k, k, s.in_channels), generator=generator) * (
            self.config.enc.w_scale / math.sqrt(fan_in)
        )
        return {
            "kernel": kernel.float().to(self.device),
            # BN offset folded into the SS-ADC counter init (paper §2), in counts
            "bn_offset": torch.zeros((s.out_channels,), dtype=torch.float32, device=self.device),
        }

    def apply(
        self,
        params: dict[str, Any],
        images: Any,
        *,
        train: bool = True,
        backend: str = "reference",
    ) -> torch.Tensor:
        """images ``(B, H, W, c_i)`` in [0, 1] -> activations ``(B, h_o, w_o, c_o)``.

        ``train=True``: differentiable path (sigmoid bucket model + STEs);
        reference backend only.
        ``train=False``: deployment path.  ``backend="reference"`` evaluates
        the circuit oracle (ground truth); fused backends route through the
        (deprecated) ``fpca_forward`` shim to the fpca kernel; prefer
        ``repro_torch.fpca.compile(program).run(images)`` for fused serving.
        """
        cfg = self.config
        # imported here: repro_torch.fpca.backends imports this package
        from repro_torch.fpca.backends import available_backends, get_backend

        if train and not (backend in available_backends() and get_backend(backend).differentiable):
            raise ValueError(
                "training needs the differentiable reference backend "
                "(fused kernels round the ADC hard)"
            )
        mode = "bucket_sigmoid" if (train or backend != "reference") else "oracle"
        out = fpca_forward(
            torch.as_tensor(images, dtype=torch.float32, device=self.device),
            params["kernel"],
            cfg.spec,
            circuit=cfg.circuit,
            model=self.model,
            adc=cfg.adc,
            enc=cfg.enc,
            bn_offset_counts=params["bn_offset"],
            mode=mode,
            hard=not train,
            backend=backend,
        )
        # counts -> approximate convolution units (digital gain calibration)
        return out["counts"] * (cfg.adc.lsb * self.gain)
