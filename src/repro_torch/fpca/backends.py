"""Pluggable execution backends for the FPCA frontend.

Each :class:`Backend` names one way of evaluating a programmed array and
carries ``conv``, the one-shot batched forward that
:func:`repro_torch.core.fpca_sim.fpca_forward` dispatches fused backends
through, and ``make_executable``: a factory returning a fresh
``(images, kernel, bn_offset[, window_mask]) -> counts`` closure whose
constant tables live (and die) with it.  :class:`repro_torch.fpca.CompiledFrontend`
holds those closures in its bounded LRU cache, beside the whole-model
closures of :meth:`Backend.make_model_executable` and the K-tick streaming
segments of :meth:`Backend.make_segment_executable` (one CUDA graph each on
the card).

Built-ins:

* ``"cuda"``      — the hand-written CUDA kernel (``csrc/fpca_conv.cu``);
  the default on the card.  For CPU tensors it runs the kernel's plain
  version.
* ``"basis"``     — the kernel's math in plain PyTorch; the default on the
  host, and the one backend that lowers the int8 transfer LUT of
  ``precision="int8"`` model programs (``quant_transfer``).
* ``"reference"`` — the dense oracle (predict_sigmoid + updown_readout):
  every window evaluated, skipped ones zeroed after the fact; not fused,
  and the one differentiable backend (training runs it through
  ``fpca_forward``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch.core import gating
from repro_torch.core.adc import ADCConfig, updown_readout
from repro_torch.core.curvefit import BucketCurvefitModel
from repro_torch.core.fpca_sim import WeightEncoding, _analog_read, encode_weights, extract_windows
from repro_torch.core.mapping import FPCASpec, output_dims
from repro_torch.fpca import telemetry
from repro_torch.kernels.fpca_conv.ops import fpca_conv, make_fpca_conv_executable
from repro_torch.training.tree import tree_leaves, tree_map

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

    ``fused`` marks backends that serve the calibrated bucket-sigmoid model
    with hard ADC rounding through a single fused call (deployment-mode
    serving of the sensor model); non-fused backends run the dense
    simulation and may be ``differentiable``.  ``conv`` is a fused
    backend's one-shot entry point, ``conv(images, kernel, model, *, spec,
    adc, enc, bn_offset, window_mask=None) -> counts``.

    ``bucket_sensitive`` marks backends whose executables differ per
    region-skip row bucket; the dense oracle serves every bucket with one
    executable, so caches collapse its key.  ``quant_transfer`` marks
    backends whose ``make_executable`` takes ``transfer="int8"``; the others
    serve the f32 frontend under an int8 head.
    """

    name: str
    make_executable: Callable
    conv: Callable | None = None
    fused: bool = True
    differentiable: bool = False
    bucket_sensitive: bool = True
    quant_transfer: bool = False
    description: str = ""

    def instrumented(self, fn: Callable, *, site: str) -> Callable:
        """Wrap an executable with the opt-in device-profile hooks of
        :func:`repro_torch.fpca.telemetry.instrument_launch` (launch count,
        the profiler range ``fpca.launch.<site>``, sampled device time),
        labelled ``{site, backend}``.  :class:`repro_torch.fpca.CompiledFrontend`
        routes every executable it builds through this; with telemetry off
        it costs an ``is None`` check and a profiler check per call."""
        return telemetry.instrument_launch(fn, site=site, backend=self.name)

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
            counts = frontend(images, kernel, bn_offset, *window_mask)
            with telemetry.layer("head"):
                return head(head_params, counts)

        return run

    def make_segment_executable(
        self,
        bucket_model: BucketCurvefitModel,
        *,
        spec: FPCASpec,
        adc: ADCConfig | None = None,
        enc: WeightEncoding | None = None,
        device: torch.device,
        length: int,
        gated: bool = True,
        m_bucket: int | None = None,
        model_program=None,                 # repro_torch.fpca.FPCAModelProgram
        early_exit: int | None = None,
        donate: bool = False,
    ) -> Callable:
        """A **segment** executable: ``length`` streaming ticks in one call,
        the delta gate, hysteresis ages and keyframe cadence in the carry.

        One tick body, written in torch, serves both devices.  Per tick it
        steps the gate (:func:`repro_torch.core.gating.gate_tick`, the
        numerics the per-tick loop runs on the same device), derives the
        window mask, and runs this backend's frontend with ``m_bucket = M``:
        every kept window compacted by an index built on the device, the
        fpca kernel walking the device count of kept rows.  The reference's
        branches are predication on the device:

        * zero kept windows -> the kernel walks no rows (exact zeros), and a
          model keeps its previous logits bit for bit
          (``where(n_keep == 0, logits_prev, head(eff))``);
        * ``n_keep > m_bucket`` -> the same launch walks ``n_keep`` rows,
          bit-identical to masked dense (the kernel's rows are independent),
          so ``m_bucket`` only sizes the host accounting;
        * ``early_exit=p`` -> a device ``active`` flag (fewer than ``p``
          consecutive all-skipped ticks so far): inactive ticks leave the
          carry unchanged, emit zeros and walk no rows, and ``ticks`` is the
          device count of active ticks.

        With ``model_program`` each tick patches the kept windows into the
        carried effective activation map and runs the head on it.

        On the host the body runs eagerly, K ticks in a Python loop.  On the
        card the first call warms the body up on a side stream, then
        captures all K ticks as one ``torch.cuda.CUDAGraph``; every call
        copies its inputs (frames, weights, head parameters, gate knobs,
        carry) into the graph's static buffers, replays it and clones the
        outputs.  The gate knobs and weights are data, so a servo step or a
        ``reprogram`` between segments builds nothing.  A capture that fails
        raises; the card never falls back to the eager loop.

        Returned closure::

            run(frames, kernel, bn_offset, head_params, gate_args, carry)
              -> (outs, new_carry)

        ``head_params`` is None without a model, ``gate_args = (threshold
        f32, hysteresis i32, interval i32)`` 0-d tensors (None when not
        gated), ``carry`` the flat gate-state tuple (plus ``(eff, logits)``
        for models); ``outs`` maps ``counts``, ``block_keep``, ``kept``,
        ``keyframe``, ``ticks`` (and ``logits``).  ``donate`` is accepted
        for the reference's signature: the carry is always copied into the
        graph's static buffers, so the caller's tensors stay valid.
        """
        del donate
        adc = adc or ADCConfig()
        enc = enc or WeightEncoding()
        K = int(length)
        if K < 1:
            raise ValueError("segment length must be >= 1")
        if early_exit is not None and not gated:
            raise ValueError("early_exit requires a gated segment")
        h_o, w_o = output_dims(spec)
        M = h_o * w_o
        bh, bw = gating.block_grid(spec)
        head = model_program.apply_head if model_program is not None else None
        kw = {}
        if self.quant_transfer and model_program is not None and model_program.precision == "int8":
            kw["transfer"] = "int8"
        frontend = self.make_executable(
            bucket_model, spec=spec, adc=adc, enc=enc, m_bucket=M if gated else None, device=device, **kw
        )

        def body(frames, kernel, bn_offset, head_params, gate_args, carry):
            dev = frames.device
            gate_carry = gating.GateCarry(*carry[:4])
            eff_prev, logits_prev = (carry[4], carry[5]) if head is not None else (None, None)
            quiet = torch.zeros((), dtype=torch.int32, device=dev)
            ticks = torch.zeros((), dtype=torch.int32, device=dev) if early_exit is not None else None
            outs: dict[str, list] = {"counts": [], "block_keep": [], "kept": [], "keyframe": []}
            if head is not None:
                outs["logits"] = []
            for t in range(K):
                frame = frames[t]
                active = None
                if gated:
                    cur = gating.effective_frame(frame, spec)
                    new_gate, keep, keyframe = gating.gate_tick(spec, gate_carry, cur, *gate_args)
                    window = gating.window_mask_from_blocks(keep, spec)
                    if early_exit is not None:
                        active = quiet < early_exit
                        window, keep, keyframe = window & active, keep & active, keyframe & active
                        new_gate = gating.GateCarry(
                            *(torch.where(active, n, o) for n, o in zip(new_gate, gate_carry))
                        )
                    n_keep = window.sum(dtype=torch.int32)
                    counts = frontend(frame[None], kernel, bn_offset, window[None])[0]
                else:
                    keep = torch.ones((bh, bw), dtype=torch.bool, device=dev)
                    keyframe = torch.zeros((), dtype=torch.bool, device=dev)
                    n_keep = torch.full((), M, dtype=torch.int32, device=dev)
                    new_gate = gate_carry._replace(frame_idx=gate_carry.frame_idx + 1)
                    counts = frontend(frame[None], kernel, bn_offset)[0]
                gate_carry = new_gate
                if active is not None:
                    quiet = torch.where(active, torch.where(n_keep == 0, quiet + 1, 0), quiet)
                    ticks = ticks + active.to(torch.int32)
                outs["counts"].append(counts)
                outs["block_keep"].append(keep)
                outs["kept"].append(n_keep)
                outs["keyframe"].append(keyframe)
                if head is not None:
                    if gated:
                        # a zero-kept (or inactive) tick has an all-False
                        # window, so eff is eff_prev and the logits the
                        # previous ones, bit for bit
                        eff = torch.where(window[..., None], counts, eff_prev)
                        logits = torch.where(n_keep == 0, logits_prev, head(head_params, eff[None])[0])
                    else:
                        eff = counts
                        logits = head(head_params, eff[None])[0]
                    eff_prev, logits_prev = eff, logits
                    outs["logits"].append(logits if active is None else torch.where(active, logits, 0.0))
            stacked = {k: torch.stack(v) for k, v in outs.items()}
            stacked["ticks"] = torch.full((), K, dtype=torch.int32, device=dev) if ticks is None else ticks
            new_carry = tuple(gate_carry) + ((eff_prev, logits_prev) if head is not None else ())
            return stacked, new_carry

        if device.type == "cuda":
            return _CapturedSegment(body, device)
        return body


class _CapturedSegment:
    """A segment body captured as one CUDA graph on its first call, then
    replayed: each call copies its arguments into the graph's static input
    buffers, replays, and returns clones of the static outputs.
    ``capture_ms`` is the host time the warm-up and capture took."""

    def __init__(self, body: Callable, device: torch.device):
        self._body = body
        self._device = device
        self._graph: torch.cuda.CUDAGraph | None = None
        self._static: tuple = ()
        self._out: Any = None
        self.capture_ms: float | None = None

    def _capture(self, args: tuple) -> None:
        t0 = time.perf_counter()
        for leaf in tree_leaves(args):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"segment inputs must be tensors to be staged, got {type(leaf).__name__}")
        self._static = tree_map(lambda a: a.to(self._device).clone(), args)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(torch.cuda.current_stream(self._device))
        # the warm-up builds the kernel library and sets its function
        # attributes, and creates the cuBLAS / cuDNN handles: none of that
        # may happen under capture
        with torch.cuda.stream(side):
            self._body(*self._static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self._out = self._body(*self._static)
        torch.cuda.current_stream(self._device).wait_stream(side)
        self._graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def __call__(self, *args):
        if self._graph is None:
            self._capture(args)
        else:
            with telemetry.layer("segment.stage"):
                for dst, src in zip(tree_leaves(self._static), tree_leaves(args), strict=True):
                    if dst.shape != src.shape:
                        raise ValueError(f"segment input of shape {tuple(src.shape)}, captured as {tuple(dst.shape)}")
                    dst.copy_(src, non_blocking=True)
        with telemetry.layer("segment.replay"):
            self._graph.replay()
            return tree_map(torch.clone, self._out)


_REGISTRY: dict[str, Backend] = {}


def register_backend(
    name: str,
    *,
    conv: Callable | None = None,
    fused: bool = True,
    differentiable: bool = False,
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
            conv=conv,
            fused=fused,
            differentiable=differentiable,
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


def _fused_conv(impl: str) -> Callable:
    """``Backend.conv`` of a fused backend: the one-shot fpca kernel call."""
    return functools.partial(fpca_conv, impl=impl)


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
    conv=_fused_conv("cuda"),
    description="hand-written CUDA kernel for sm_90a (plain PyTorch version on CPU tensors)",
)(_fused_factory("cuda"))

register_backend(
    "basis",
    conv=_fused_conv("basis"),
    quant_transfer=True,
    description="the kernel's basis-bank math in plain PyTorch",
)(_fused_factory("basis"))


@register_backend(
    "reference",
    fused=False,
    differentiable=True,
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
        n = spec.n_active_pixels
        v_pos = _analog_read(I, w_pos, "bucket_sigmoid", None, model, n)
        v_neg = _analog_read(I, w_neg, "bucket_sigmoid", None, model, n)
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
