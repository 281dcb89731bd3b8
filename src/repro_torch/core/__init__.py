"""FPCA core: the paper's contribution as composable torch modules.

* :mod:`repro_torch.core.device_models` — physics-inspired analog circuit
  oracle (the SPICE stand-in);
* :mod:`repro_torch.core.curvefit`      — two-step bucket-select curvefit
  model (paper §4), hard and differentiable variants;
* :mod:`repro_torch.core.mapping`       — spec, Eq. 1 cycle model and
  schedule, region skipping;
* :mod:`repro_torch.core.adc`           — up/down SS-ADC with BN fold + ReLU
  clamp;
* :mod:`repro_torch.core.fpca_sim`      — end-to-end functional frontend
  simulator;
* :mod:`repro_torch.core.frontend`      — trainable FPCAFrontend layer;
* :mod:`repro_torch.core.analysis`      — energy / latency / bandwidth
  models (Eqs. 2--8, Fig. 9);
* :mod:`repro_torch.core.gating`        — the streaming delta gate.
"""

from repro_torch.core.adc import ADCConfig, quantize_voltage, updown_readout
from repro_torch.core.analysis import (
    FrontendConstants,
    bandwidth_reduction,
    conventional_cis,
    frontend_energy,
    frontend_latency,
)
from repro_torch.core.curvefit import (
    BucketCurvefitModel,
    PolySurface,
    fit_bucket_model,
    predict_hard,
    predict_sigmoid,
)
from repro_torch.core.device_models import CircuitParams, analog_dot_product, pixel_drive
from repro_torch.core.fpca_sim import (
    WeightEncoding,
    calibrate_gain,
    encode_weights,
    extract_windows,
    fpca_forward,
)
from repro_torch.core.frontend import FPCAFrontend
from repro_torch.core.mapping import (
    FPCASpec,
    active_window_mask,
    n_cycles,
    n_cycles_with_skipping,
    output_dims,
    schedule,
)


def __getattr__(name: str):
    # the deprecated name forwards lazily so `import repro_torch.core` stays
    # clean under -W error::DeprecationWarning; accessing it warns
    if name == "FPCAFrontendConfig":
        from repro_torch.core import frontend

        return frontend.FPCAFrontendConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ADCConfig",
    "BucketCurvefitModel",
    "CircuitParams",
    "FPCAFrontend",
    "FPCAFrontendConfig",
    "FPCASpec",
    "FrontendConstants",
    "PolySurface",
    "WeightEncoding",
    "active_window_mask",
    "analog_dot_product",
    "bandwidth_reduction",
    "calibrate_gain",
    "conventional_cis",
    "encode_weights",
    "extract_windows",
    "fit_bucket_model",
    "fpca_forward",
    "frontend_energy",
    "frontend_latency",
    "n_cycles",
    "n_cycles_with_skipping",
    "output_dims",
    "pixel_drive",
    "predict_hard",
    "predict_sigmoid",
    "quantize_voltage",
    "schedule",
    "updown_readout",
]
