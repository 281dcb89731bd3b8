"""Declarative FPCA program spec — what is programmed into the array.

* the **program** pins the compiled artifact: two programs with equal
  signatures share one executable;
* the **weights** (NVM conductance planes, head parameters) enter every call
  as tensors, so reprogramming them never rebuilds an executable.

Signatures are versioned primitive tuples (ints / floats / strs only), and
byte-equal to the reference package's for the same program, so a cache key
means the same thing on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.adc import ADCConfig
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.mapping import FPCASpec, output_dims

__all__ = [
    "DeltaGateConfig",
    "GateControllerConfig",
    "FPCAProgram",
    "ProgrammedConfig",
    "spec_signature",
    "ConvSpec",
    "PoolSpec",
    "DenseSpec",
    "ActivationSpec",
    "FPCAModelProgram",
    "ProgrammedModel",
]

_SIG_VERSION = "repro.fpca/1"
_MODEL_SIG_VERSION = "repro.fpca.model/1"


@dataclasses.dataclass(frozen=True)
class DeltaGateConfig:
    """Temporal delta gate knobs (streaming runs them; a later slice)."""

    threshold: float = 0.02      # mean |Δ| per block that counts as "changed"
    hysteresis: int = 1          # frames a block stays live after its change
    keyframe_interval: int = 30  # full-frame refresh period (0 = never)


@dataclasses.dataclass(frozen=True)
class GateControllerConfig:
    """Closed-loop gate-threshold servo knobs (streaming runs them; a later
    slice).  Validated here so a program that carries one is well formed."""

    target: float = 0.15
    metric: str = "keep"            # "keep" | "energy"
    ema_alpha: float = 0.4
    kp: float = 0.35
    ki: float = 0.03
    max_step: float = 0.4
    leak: float = 0.85
    windup: float = 2.0
    err_low: float = -1.0
    err_high: float = 3.0
    deadband: float = 0.0
    min_threshold: float = 1e-4
    max_threshold: float = 1.0
    history_len: int = 512

    def __post_init__(self) -> None:
        if not 0.0 < self.target <= 1.0:
            raise ValueError("target must be in (0, 1]")
        if self.metric not in ("keep", "energy"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if self.max_step <= 0.0:
            raise ValueError("max_step must be > 0")
        if not 0.0 <= self.leak <= 1.0:
            raise ValueError("leak must be in [0, 1]")
        if self.err_low >= self.err_high:
            raise ValueError("need err_low < err_high")
        if not 0.0 < self.min_threshold <= self.max_threshold:
            raise ValueError("need 0 < min_threshold <= max_threshold")
        if self.history_len < 1:
            raise ValueError("history_len must be >= 1")


def spec_signature(
    spec: FPCASpec, out_channels: int, adc: ADCConfig, enc: WeightEncoding
) -> tuple:
    """Hashable compiled-kernel signature, as a versioned primitive tuple."""
    return (
        _SIG_VERSION,
        ("spec", int(spec.image_h), int(spec.image_w), int(spec.out_channels),
         int(spec.kernel), int(spec.stride), int(spec.max_kernel),
         int(spec.in_channels), int(spec.padding), int(spec.binning),
         int(spec.skip_block)),
        ("out_channels", int(out_channels)),
        ("adc", int(adc.bits), float(adc.v_ref)),
        ("enc", int(enc.n_levels), float(enc.w_scale)),
    )


@dataclasses.dataclass(frozen=True)
class FPCAProgram:
    """One validated FPCA array program.

    ``spec`` (geometry), ``circuit`` (constants the bucket model is fitted
    against), ``adc`` / ``enc`` (epilogue constants) and ``out_channels`` are
    compiled in.  ``gate`` / ``controller`` are runtime knobs, excluded from
    :meth:`signature`.
    """

    spec: FPCASpec
    circuit: CircuitParams = CircuitParams()
    adc: ADCConfig = ADCConfig()
    enc: WeightEncoding = WeightEncoding()
    out_channels: int | None = None
    gate: DeltaGateConfig | None = None
    controller: GateControllerConfig | None = None

    def __post_init__(self) -> None:
        if self.out_channels is None:
            object.__setattr__(self, "out_channels", self.spec.out_channels)
        if int(self.out_channels) < 1:
            raise ValueError("out_channels must be >= 1")
        if self.controller is not None and not isinstance(self.controller, GateControllerConfig):
            raise TypeError("controller must be a GateControllerConfig")
        if self.gate is not None and not isinstance(self.gate, DeltaGateConfig):
            raise TypeError("gate must be a DeltaGateConfig")

    @property
    def out_shape(self) -> tuple[int, int, int]:
        h_o, w_o = output_dims(self.spec)
        return (h_o, w_o, int(self.out_channels))

    @property
    def kernel_shape(self) -> tuple[int, int, int, int]:
        """Shape of the float kernel this program accepts: (c_o, k, k, c_i)."""
        s = self.spec
        return (int(self.out_channels), s.kernel, s.kernel, s.in_channels)

    def signature(self) -> tuple:
        """Stable compile signature: :func:`spec_signature` plus the circuit
        constants (baked in through the fitted bucket model)."""
        sig = self.__dict__.get("_signature")
        if sig is None:
            circuit = tuple(
                (f.name, float(getattr(self.circuit, f.name)))
                for f in dataclasses.fields(self.circuit)
            )
            sig = spec_signature(self.spec, int(self.out_channels), self.adc, self.enc) + (
                ("circuit",) + circuit,
            )
            object.__setattr__(self, "_signature", sig)
        return sig

    def fanout_signature(self) -> tuple:
        """Compile signature with the channel width normalised out.  Two
        programs may fan out into one channel-stacked launch (their NVM
        planes concatenated) iff these match: the stacked launch serves one
        adc/enc/circuit epilogue."""
        return self.replace(out_channels=1).signature()

    def replace(self, **kw: Any) -> "FPCAProgram":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProgrammedConfig:
    """A program bound to NVM weights — one named, field-programmed state."""

    name: str
    program: FPCAProgram
    kernel: torch.Tensor            # (c_o, k, k, c_i) float weights
    bn_offset: torch.Tensor         # (c_o,) counts

    @property
    def spec(self) -> FPCASpec:
        return self.program.spec

    @property
    def out_channels(self) -> int:
        return int(self.program.out_channels)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return self.program.out_shape


# ---------------------------------------------------------------------------
# Multi-layer model programs: analog frontend + digital head
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default form
    "silu": F.silu,
    "tanh": torch.tanh,
}


def _check_activation(act: str | None) -> None:
    if act is not None and act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; available: {tuple(_ACTIVATIONS)}")


def _apply_activation(act: str | None, x: torch.Tensor) -> torch.Tensor:
    return x if act is None else _ACTIVATIONS[act](x)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One digital convolution stage of a model head (NHWC, biased)."""

    out_channels: int
    kernel: int
    stride: int = 1
    padding: str = "VALID"          # "VALID" | "SAME"
    activation: str | None = "relu"

    def __post_init__(self) -> None:
        if self.out_channels < 1 or self.kernel < 1 or self.stride < 1:
            raise ValueError("conv out_channels/kernel/stride must be >= 1")
        if self.padding not in ("VALID", "SAME"):
            raise ValueError(f"padding must be VALID or SAME, got {self.padding!r}")
        _check_activation(self.activation)

    def _sig(self) -> tuple:
        return ("conv", int(self.out_channels), int(self.kernel),
                int(self.stride), self.padding, self.activation or "")


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Spatial pooling stage (``kind``: "max" | "avg")."""

    size: int
    stride: int | None = None       # None = size (non-overlapping)
    kind: str = "max"

    def __post_init__(self) -> None:
        if self.size < 1 or (self.stride is not None and self.stride < 1):
            raise ValueError("pool size/stride must be >= 1")
        if self.kind not in ("max", "avg"):
            raise ValueError(f"pool kind must be max or avg, got {self.kind!r}")

    def _sig(self) -> tuple:
        s = self.size if self.stride is None else self.stride
        return ("pool", self.kind, int(self.size), int(s))


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    """Fully-connected stage (flattens a spatial input); the last stage of
    every head is a DenseSpec — its ``features`` are the class logits."""

    features: int
    activation: str | None = None

    def __post_init__(self) -> None:
        if self.features < 1:
            raise ValueError("dense features must be >= 1")
        _check_activation(self.activation)

    def _sig(self) -> tuple:
        return ("dense", int(self.features), self.activation or "")


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """A bare nonlinearity stage."""

    fn: str = "relu"

    def __post_init__(self) -> None:
        _check_activation(self.fn)

    def _sig(self) -> tuple:
        return ("act", self.fn)


LayerSpec = ConvSpec | PoolSpec | DenseSpec | ActivationSpec
_LAYER_SPECS = (ConvSpec, PoolSpec, DenseSpec, ActivationSpec)




def _as_tensor(v: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor`` that copies a read-only numpy array first."""
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = v.copy()
    return torch.as_tensor(v, dtype=dtype, device=device)


def _as_f32_stage(p: Any, device) -> dict[str, torch.Tensor]:
    """One stage's parameters as float32 tensors on ``device`` (their own
    when None), keys sorted as the reference's tree map leaves them."""
    return {k: _as_tensor(v, torch.float32, device) for k, v in sorted(dict(p).items())}


def _dense_in(shape: tuple[int, ...]) -> int:
    d_in = 1
    for d in shape:
        d_in *= int(d)
    return d_in


def _evaluate_chain(head: tuple, x: torch.Tensor, *, conv, linear, params: list, on_stage=None) -> torch.Tensor:
    """Run a chain head on ``x``.  ``conv(p, x, stride, padding)`` and
    ``linear(p, x)`` lower the parameterized stages (f32 or int8);
    ``on_stage(i, x)``, when given, sees each parameterized stage's input
    before it runs (calibration)."""
    from repro_torch.models.layers import avg_pool2d, max_pool2d

    for i, (layer, p) in enumerate(zip(head, params)):
        if isinstance(layer, ConvSpec):
            if on_stage is not None:
                on_stage(i, x)
            x = _apply_activation(layer.activation, conv(p, x, layer.stride, layer.padding))
        elif isinstance(layer, PoolSpec):
            pool = max_pool2d if layer.kind == "max" else avg_pool2d
            x = pool(x, layer.size, layer.stride)
        elif isinstance(layer, DenseSpec):
            if x.ndim > 2:
                x = x.reshape(x.shape[0], -1)
            if on_stage is not None:
                on_stage(i, x)
            x = _apply_activation(layer.activation, linear(p, x))
        else:
            x = _apply_activation(layer.fn, x)
    return x


@dataclasses.dataclass(frozen=True)
class FPCAModelProgram:
    """One validated multi-layer model: FPCA frontend + digital head.

    * ``frontend``    — the analog first layer (:class:`FPCAProgram`);
    * ``head``        — the digital stages applied to the SS-ADC counts: a
      chain of layer specs whose last is a :class:`DenseSpec` (the class
      logits), or a :class:`repro_torch.models.heads.HeadGraph` (residual,
      multi-branch and detection heads of :mod:`repro_torch.fpca.zoo`);
    * ``input_scale`` — counts -> activation-unit scale applied before the
      head (compiled in, hence in the signature);
    * ``arch``        — the zoo name the program was built under; a label
      only, excluded from :meth:`signature`;
    * ``precision``   — ``"f32"`` or ``"int8"`` (per-channel symmetric int8
      weights, calibrated int8 activations, int32 accumulation,
      :mod:`repro_torch.models.quant`).  In the signature only off the f32
      default; the quantised parameters, scales included, are call
      arguments, so reprogramming them builds nothing.
    """

    frontend: FPCAProgram
    head: Any
    input_scale: float = 1.0
    arch: str | None = None
    precision: str = "f32"

    def __post_init__(self) -> None:
        if not isinstance(self.frontend, FPCAProgram):
            raise TypeError("frontend must be an FPCAProgram")
        if self.precision not in ("f32", "int8"):
            raise ValueError(f"unknown precision {self.precision!r}; available: ('f32', 'int8')")
        from repro_torch.models.heads import HeadGraph

        if isinstance(self.head, HeadGraph):
            if not float(self.input_scale) > 0.0:
                raise ValueError("input_scale must be > 0")
            self.head.shapes(self.frontend.out_shape)   # validates node geometry
            return
        object.__setattr__(self, "head", tuple(self.head))
        if not self.head:
            raise ValueError("model head needs at least one layer spec")
        for layer in self.head:
            if not isinstance(layer, _LAYER_SPECS):
                raise TypeError(f"unknown head layer spec {layer!r}")
        if not isinstance(self.head[-1], DenseSpec):
            raise ValueError("the last head stage must be a DenseSpec (the class logits)")
        if not float(self.input_scale) > 0.0:
            raise ValueError("input_scale must be > 0")
        self.head_shapes()   # validates the layer geometry chains

    # -- derived geometry ----------------------------------------------------
    @property
    def is_graph_head(self) -> bool:
        from repro_torch.models.heads import HeadGraph

        return isinstance(self.head, HeadGraph)

    def head_shapes(self) -> list[tuple[int, ...]]:
        """Output shape after each head stage (index 0 = frontend output)."""
        if self.is_graph_head:
            raise TypeError(
                "head_shapes() is for chain heads; a HeadGraph head exposes per-node shapes via "
                "model.head.shapes(model.frontend.out_shape)"
            )
        shapes: list[tuple[int, ...]] = [self.frontend.out_shape]
        for i, layer in enumerate(self.head):
            cur = shapes[-1]
            if isinstance(layer, (ConvSpec, PoolSpec)) and len(cur) != 3:
                kind = "conv" if isinstance(layer, ConvSpec) else "pool"
                raise ValueError(f"head[{i}]: {kind} needs a spatial (h, w, c) input, got shape {cur}")
            if isinstance(layer, ConvSpec):
                h, w, _ = cur
                if layer.padding == "SAME":
                    h_o, w_o = -(-h // layer.stride), -(-w // layer.stride)
                else:
                    if layer.kernel > h or layer.kernel > w:
                        raise ValueError(f"head[{i}]: conv kernel {layer.kernel} exceeds input {h}x{w}")
                    h_o = (h - layer.kernel) // layer.stride + 1
                    w_o = (w - layer.kernel) // layer.stride + 1
                shapes.append((h_o, w_o, layer.out_channels))
            elif isinstance(layer, PoolSpec):
                h, w, c = cur
                if layer.size > h or layer.size > w:
                    raise ValueError(f"head[{i}]: pool size {layer.size} exceeds input {h}x{w}")
                s = layer.size if layer.stride is None else layer.stride
                shapes.append(((h - layer.size) // s + 1, (w - layer.size) // s + 1, c))
            elif isinstance(layer, DenseSpec):
                shapes.append((layer.features,))
            else:                       # ActivationSpec: shape-preserving
                shapes.append(cur)
        return shapes

    @property
    def n_classes(self) -> int:
        if self.is_graph_head:
            return int(self.head.n_classes)
        return int(self.head[-1].features)

    @property
    def head_out_shape(self) -> tuple[int, ...]:
        """Per-example head output: ``(n_classes,)`` for classifiers, the
        graph's output shape (``(gh, gw, C + 4)`` for detection) otherwise."""
        if self.is_graph_head:
            return tuple(self.head.out_shape(self.frontend.out_shape))
        return (self.n_classes,)

    @property
    def output_kind(self) -> str:
        """``"logits"`` (classifier) or ``"detections"`` (per-cell maps)."""
        return self.head.output_kind if self.is_graph_head else "logits"

    @property
    def detect_classes(self) -> int | None:
        """Class count of a detection head (``None`` for classifiers)."""
        return self.n_classes if self.output_kind == "detections" else None

    @property
    def spec(self) -> FPCASpec:
        return self.frontend.spec

    @property
    def out_channels(self) -> int:
        return int(self.frontend.out_channels)

    # -- parameters ----------------------------------------------------------
    def _param_shapes(self) -> list[dict[str, tuple[int, ...]]]:
        """Per chain stage, its parameter shapes (``{}`` when it has none)."""
        shapes = self.head_shapes()
        out = []
        for i, layer in enumerate(self.head):
            cur = shapes[i]
            if isinstance(layer, ConvSpec):
                out.append({"w": (layer.out_channels, layer.kernel, layer.kernel, cur[-1]),
                            "b": (layer.out_channels,)})
            elif isinstance(layer, DenseSpec):
                out.append({"w": (_dense_in(cur), layer.features), "b": (layer.features,)})
            else:
                out.append({})
        return out

    def init_head(
        self,
        generator: torch.Generator | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> Any:
        """Fresh f32 head parameters drawn from the CPU ``generator``: one
        dict per chain stage (``{}`` for parameterless stages), or a dict
        keyed by node name for a graph head."""
        if self.is_graph_head:
            return self.head.init(generator, self.frontend.out_shape, device=device)
        from repro_torch.models.layers import init_conv2d, init_linear

        params: list[dict] = []
        for layer, want in zip(self.head, self._param_shapes()):
            if isinstance(layer, ConvSpec):
                c_out, k, _, c_in = want["w"]
                params.append(init_conv2d(c_in, c_out, k, generator=generator, device=device))
            elif isinstance(layer, DenseSpec):
                params.append(init_linear(*want["w"], generator=generator, device=device))
            else:
                params.append({})
        return params

    def bind_head_params(self, params: Any, *, device: str | torch.device | None = None) -> Any:
        """Validate and coerce head parameters (tensors or numpy arrays) onto
        ``device`` (their own device when None), so a stage-count or shape
        mismatch fails at the call site.

        With ``precision="int8"`` an already-quantised tree (``w_q`` leaves)
        is validated and bound as it is; an f32 tree is quantised on the
        spot with the data-free full-scale calibration
        (:func:`repro_torch.models.quant.quantize_head_params`)."""
        if self.precision == "int8":
            from repro_torch.models import quant

            if quant.is_quantized_params(params):
                return quant.bind_quant_head_params(self, params, device=device)
            return quant.quantize_head_params(self, params, device=device)
        return self._bind_f32(params, device=device)

    def _bind_f32(self, params: Any, *, device: str | torch.device | None = None) -> Any:
        """The f32 binding path (also the pre-quantisation validator)."""
        if self.is_graph_head:
            return self.head.bind(params, self.frontend.out_shape, device=device)
        bound = [_as_f32_stage(p, device) for p in params]
        if len(bound) != len(self.head):
            raise ValueError(
                f"head has {len(self.head)} stages but got {len(bound)} parameter entries"
            )
        for i, (layer, p, want) in enumerate(zip(self.head, bound, self._param_shapes())):
            got = {k: tuple(v.shape) for k, v in p.items()}
            if got != want:
                raise ValueError(
                    f"head[{i}] ({type(layer).__name__}): parameter shapes {got} "
                    f"do not match expected {want}"
                )
        return bound

    def apply_head(self, params: Any, counts: torch.Tensor) -> torch.Tensor:
        """The head: SS-ADC counts ``(b, h_o, w_o, c_o)`` -> ``(b,) +
        head_out_shape`` (logits, or raw per-cell detection maps), through
        :mod:`repro_torch.models.layers`.  ``precision="int8"`` lowers it
        through :func:`repro_torch.models.quant.apply_head_int8` instead."""
        if self.precision == "int8":
            from repro_torch.models.quant import apply_head_int8

            return apply_head_int8(self, params, counts)
        x = counts.float() * float(self.input_scale)
        if self.is_graph_head:
            return self.head.apply(params, x)
        if len(params) != len(self.head):
            raise ValueError(
                f"head has {len(self.head)} stages but got {len(params)} parameter entries"
            )
        from repro_torch.models.layers import conv2d, linear

        return _evaluate_chain(self.head, x, conv=conv2d, linear=linear, params=params)

    # -- identity ------------------------------------------------------------
    def signature(self) -> tuple:
        """Stable model compile signature extending the frontend's: head
        specs, ``input_scale`` and a non-default ``precision`` are compiled
        in; parameters and ``arch`` are not."""
        sig = self.__dict__.get("_signature")
        if sig is None:
            if self.is_graph_head:
                head_sig = ("head_graph",) + self.head._sig_entries()
            else:
                head_sig = ("head",) + tuple(layer._sig() for layer in self.head)
            sig = (
                (_MODEL_SIG_VERSION,)
                + self.frontend.signature()
                + (head_sig, ("input_scale", float(self.input_scale)))
            )
            if self.precision != "f32":
                # appended only off the f32 default, so every f32 signature
                # stays byte-equal to the reference's
                sig = sig + (("precision", self.precision),)
            object.__setattr__(self, "_signature", sig)
        return sig

    def replace(self, **kw: Any) -> "FPCAModelProgram":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProgrammedModel:
    """A model program bound to its trained parameters: NVM planes for the
    analog frontend plus the head parameters, the way
    :class:`ProgrammedConfig` binds a frontend program to NVM weights.
    ``program`` is the frontend program."""

    name: str
    model: FPCAModelProgram
    kernel: torch.Tensor            # (c_o, k, k, c_i) float NVM weights
    bn_offset: torch.Tensor         # (c_o,) counts
    head_params: Any                # a tree matching model.init_head()

    @property
    def program(self) -> FPCAProgram:
        return self.model.frontend

    @property
    def spec(self) -> FPCASpec:
        return self.model.frontend.spec

    @property
    def out_channels(self) -> int:
        return int(self.model.frontend.out_channels)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return self.model.frontend.out_shape
