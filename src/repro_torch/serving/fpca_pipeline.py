"""Batched multi-spec FPCA frontend serving pipeline.

The paper's headline claim is field-programmability: one pixel array serves
many (kernel, stride, channel, binning) configurations.  This module is the
serving-side counterpart: a reconfiguration scheduler that accepts a mixed
stream of frontend requests, buckets them by their compile signature, and
drives each bucket through one fused batched call.

The pipeline is a thin scheduling layer over explicit handles: every
distinct compile signature gets one :class:`repro_torch.fpca.CompiledFrontend`
(all handles share ONE bounded :class:`repro_torch.fpca.ExecutableCache`),
and batch padding, sticky region-skip buckets and the zero-kept short
circuit live behind the handle.  What remains here:

1. every request names a registered configuration (a
   :class:`repro_torch.fpca.ProgrammedConfig`: a program plus the NVM
   weights a physical FPCA would hold in its weight die) and carries one
   frame;
2. requests are grouped by configuration; each group's frames are stacked
   into one ``(B, H, W, c_i)`` batch;
3. each group runs through its signature's handle: configurations sharing
   (spec, c_o, adc, enc, circuit) share one handle and one executable,
   because weights are call arguments;
4. results scatter back to the original request order.

With ``cross_config_batching=True``, groups whose configurations share a
compile signature merge into ONE call with their NVM weight planes stacked
along the channel axis (each request's counts are sliced from its
configuration's channel range).  On the card every fused call is one launch
of the fpca_conv kernel (``csrc/fpca_conv.cu``).

Entry points: :meth:`FPCAPipeline.serve` (request mix) and
:meth:`FPCAPipeline.run_config_batch`, the non-blocking call the streaming
server (:mod:`repro_torch.serving.streaming`) dispatches through.
:meth:`FPCAPipeline.submit` is a deprecation shim forwarding to ``serve``.
With ``mesh=`` every handle serves data-parallel over the mesh's data axes
(:class:`repro_torch.fpca.CompiledFrontend`): every rank runs the same
scheduling and gate work on the host and launches the kernel on its rows
of each fused batch, and the counts are all-gathered.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import fpca as _fpca
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import BucketCurvefitModel, fit_bucket_model
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.mapping import FPCASpec, active_window_mask, output_dims
from repro_torch.device import resolve_device
from repro_torch.fpca import telemetry
from repro_torch.fpca.cache import ExecutableCache
from repro_torch.fpca.executable import (
    _USE_PROGRAM,
    CompiledFrontend,
    CompiledModel,
    SegmentResult,
)
from repro_torch.fpca.program import (
    FPCAModelProgram,
    FPCAProgram,
    ProgrammedConfig,
    ProgrammedModel,
    _as_tensor,
    spec_signature,
)
from repro_torch.models.heads import Detections

__all__ = [
    "FrontendRequest",
    "FrontendConfig",
    "PipelineStats",
    "FPCAPipeline",
    "CalibrationKeyError",
    "spec_signature",
]


class CalibrationKeyError(ValueError):
    """A calibration handed to :class:`FPCAPipeline` as a plain
    :class:`BucketCurvefitModel` is implicitly keyed to the default
    :class:`CircuitParams`: serving a program that carries a custom circuit
    from it would pair the wrong physics with the program.  Key calibrations
    explicitly as ``{(circuit, n_pixels): model}`` to serve custom-circuit
    programs."""


def __getattr__(name: str) -> Any:
    if name == "FrontendConfig":
        warnings.warn(
            "FrontendConfig is deprecated; use repro.fpca.ProgrammedConfig "
            "(an FPCAProgram bound to NVM weights)",
            DeprecationWarning,
            stacklevel=2,
        )
        return ProgrammedConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class FrontendRequest:
    """One frame for one registered configuration."""

    config: str                     # registered configuration name
    image: Any                      # (H, W, c_i) float in [0, 1]
    block_mask: np.ndarray | None = None   # region skipping (§3.4.5)


class PipelineStats(telemetry.StatsView):
    """Fleet-level serving counters, registry cells.

    * ``requests``       — frames accepted by :meth:`FPCAPipeline.serve`
    * ``batches``        — fused calls (the handles' ``runs`` cells,
      parent-chained)
    * ``merged_groups``  — cross-config channel-stacked batches
    * ``fanout_batches`` — multi-config stream fan-out calls
    * ``windows_total`` / ``windows_executed`` / ``launches_skipped`` /
      ``bucket_switches`` / ``bucket_shrinks_deferred`` / ``segments`` /
      ``segment_ticks`` — parent-chained from every owned handle's
      :class:`repro_torch.fpca.FrontendStats`: the handle increments one
      cell and the delta lands here too.

    ``cache_hits`` / ``cache_misses`` / ``evictions`` are derived reads of
    the shared :class:`repro_torch.fpca.ExecutableCache`, never a copy.
    """

    _PREFIX = "fpca_pipeline"
    _FIELDS = (
        "requests",
        "batches",
        "merged_groups",
        "fanout_batches",
        "windows_total",
        "windows_executed",
        "launches_skipped",
        "bucket_switches",
        "bucket_shrinks_deferred",
        "segments",
        "segment_ticks",
    )
    _DERIVED = ("cache_hits", "cache_misses", "evictions")

    __slots__ = ("_cache_ref",)

    def __init__(self, cache: ExecutableCache | None = None, labels: dict | None = None):
        super().__init__(labels=labels)
        object.__setattr__(self, "_cache_ref", weakref.ref(cache) if cache is not None else None)

    def _cache(self) -> ExecutableCache | None:
        ref = object.__getattribute__(self, "_cache_ref")
        return ref() if ref is not None else None

    @property
    def cache_hits(self) -> int:
        c = self._cache()
        return c.hits if c is not None else 0

    @property
    def cache_misses(self) -> int:
        c = self._cache()
        return c.misses if c is not None else 0

    @property
    def evictions(self) -> int:
        c = self._cache()
        return c.evictions if c is not None else 0


class FPCAPipeline:
    """Spec-bucketed reconfiguration scheduler over compiled FPCA handles.

    Args:
      model: fitted :class:`BucketCurvefitModel` (or a dict keyed by
        ``n_active_pixels``, or by ``(CircuitParams, n_active_pixels)`` for
        custom-circuit programs); entries without an explicit circuit key
        are taken as default-``CircuitParams`` calibrations.  Missing
        entries are fitted on demand against the registering program's
        circuit, on the pipeline's device.
      backend: a name registered in :mod:`repro_torch.fpca.backends` —
        ``"cuda"`` (the fpca_conv kernel), ``"basis"`` (the same math in
        plain PyTorch), ``"reference"`` (dense oracle).  Default: ``"cuda"``
        on the card, ``"basis"`` on the host.
      device: where every handle runs; the CUDA card unless the caller
        passes another (``device="cpu"`` on a host without one).
      mesh: optional :class:`~torch.distributed.device_mesh.DeviceMesh` —
        every handle's batches shard over its data axes (see
        :func:`repro_torch.fpca.compile`).
      cache_capacity: bound on simultaneously-held executables, shared
        across ALL registered configurations.
      cross_config_batching: merge request groups whose configurations share
        a compile signature into one channel-stacked call.
      bucket_patience: sticky-bucket hysteresis for the region-skip row
        buckets (held per handle; ``1`` is stateless).
    """

    def __init__(
        self,
        model: BucketCurvefitModel | dict[Any, BucketCurvefitModel] | None = None,
        *,
        adc: ADCConfig | None = None,
        enc: WeightEncoding | None = None,
        backend: str | None = None,
        device: str | torch.device | None = None,
        mesh: Any | None = None,
        cache_capacity: int = 8,
        cross_config_batching: bool = False,
        bucket_patience: int = 1,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._backend = _fpca.get_backend(
            backend if backend is not None else _fpca.default_backend_name(self.device)
        )
        self.backend = self._backend.name
        self.adc = adc or ADCConfig()
        self.enc = enc or WeightEncoding()
        self.cross_config_batching = cross_config_batching
        if bucket_patience < 1:
            raise ValueError("bucket_patience must be >= 1")
        self.bucket_patience = bucket_patience
        # fitted bucket models keyed by (circuit, n_active_pixels); models
        # passed without a circuit key are default-circuit calibrations and
        # are trusted only for default-circuit programs (CalibrationKeyError)
        default_circuit = CircuitParams()
        self._models: dict[tuple[CircuitParams, int], BucketCurvefitModel] = {}
        self._implicitly_keyed: set[tuple[CircuitParams, int]] = set()
        if isinstance(model, BucketCurvefitModel):
            key = (default_circuit, model.n_pixels)
            self._models[key] = model
            self._implicitly_keyed.add(key)
        elif isinstance(model, dict):
            for k, v in model.items():
                key = k if isinstance(k, tuple) else (default_circuit, k)
                self._models[key] = v
                if not isinstance(k, tuple):
                    self._implicitly_keyed.add(key)
        self._configs: dict[str, ProgrammedConfig | ProgrammedModel] = {}
        # one handle per compile signature, all sharing one bounded cache
        self._handles: dict[tuple, CompiledFrontend] = {}
        self._cache = ExecutableCache(cache_capacity)
        # channel-stacked (kernel, bn, program) per fan-out tuple: configs are
        # immutable once registered, so the concat is paid once
        self._stacked: dict[tuple[str, ...], tuple[torch.Tensor, torch.Tensor, FPCAProgram]] = {}
        # handle stats parent-chain into these cells; cache counters are
        # derived reads of self._cache
        self.stats = PipelineStats(cache=self._cache)

    # -- configuration registry ----------------------------------------------
    def register(
        self,
        name: str,
        spec: FPCASpec | FPCAProgram | FPCAModelProgram,
        kernel: Any,
        bn_offset: Any | None = None,
        *,
        head_params: Any | None = None,
    ) -> ProgrammedConfig | ProgrammedModel:
        """Program one FPCA configuration under a unique name.

        ``spec`` may be a bare :class:`FPCASpec` (wrapped into a program with
        this pipeline's adc/enc), a full :class:`FPCAProgram`, or an
        :class:`FPCAModelProgram` whose ``head_params`` bind here the way the
        NVM ``kernel`` does.  Weights (numpy or tensors) move to the
        pipeline's device.  Model configurations serve class logits (or
        :class:`Detections`) through :meth:`serve`, stack channels with
        frontend configurations sharing a compile signature, and get the
        skip-aware per-tick head in
        :class:`repro_torch.serving.streaming.StreamServer`.
        """
        if name in self._configs:
            raise ValueError(f"config {name!r} already registered")
        c_o = int(kernel.shape[0])
        kernel = _as_tensor(kernel, torch.float32, self.device)
        if bn_offset is None:
            bn_offset = torch.zeros((c_o,), device=self.device)
        bn_offset = _as_tensor(bn_offset, torch.float32, self.device)
        if isinstance(spec, FPCAModelProgram):
            if int(spec.out_channels) != c_o:
                raise ValueError(
                    f"kernel has {c_o} output channels; model program for "
                    f"{name!r} specifies {spec.out_channels}"
                )
            if head_params is None:
                raise ValueError(
                    f"model program {name!r} needs head_params= (the trained "
                    f"head pytree; see FPCAModelProgram.init_head)"
                )
            mcfg = ProgrammedModel(
                name=name, model=spec, kernel=kernel, bn_offset=bn_offset,
                head_params=spec.bind_head_params(head_params, device=self.device),
            )
            self._configs[name] = mcfg
            return mcfg
        if head_params is not None:
            raise ValueError("head_params= needs an FPCAModelProgram")
        if isinstance(spec, FPCAProgram):
            if int(spec.out_channels) != c_o:
                raise ValueError(
                    f"kernel has {c_o} output channels; program for "
                    f"{name!r} specifies {spec.out_channels}"
                )
            program = spec
        else:
            program = FPCAProgram(spec=spec, adc=self.adc, enc=self.enc, out_channels=c_o)
        cfg = ProgrammedConfig(name=name, program=program, kernel=kernel, bn_offset=bn_offset)
        self._configs[name] = cfg
        return cfg

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def cache_info(self, verbose: bool = False):
        """Counters of the shared executable cache (all handles);
        ``verbose=True`` adds per-key splits, resident keys and the eviction
        log."""
        return self._cache.info(verbose)

    def _model_for(self, program: FPCAProgram) -> BucketCurvefitModel:
        key = (program.circuit, program.spec.n_active_pixels)
        if key not in self._models:
            implicit_key = (CircuitParams(), key[1])
            if implicit_key in self._implicitly_keyed:
                raise CalibrationKeyError(
                    f"this pipeline holds a calibration for "
                    f"n_pixels={key[1]} passed as a plain "
                    f"BucketCurvefitModel (implicitly a default-CircuitParams "
                    f"calibration), but the program being served carries a "
                    f"custom CircuitParams — refusing to guess which physics "
                    f"it was fitted against.  Pass calibrations keyed "
                    f"explicitly as {{(circuit, n_pixels): model}}."
                )
            self._models[key] = fit_bucket_model(program.circuit, n_pixels=key[1], device=self.device)
        return self._models[key]

    def _handle_kw(self) -> dict:
        return dict(
            backend=self._backend, device=self.device, mesh=self.mesh, cache=self._cache,
            bucket_patience=self.bucket_patience, stats_parent=self.stats,
        )

    def handle_for(self, program: FPCAProgram | FPCASpec, out_channels: int | None = None) -> CompiledFrontend:
        """The shared :class:`CompiledFrontend` serving one compile signature
        (created lazily, keyed by ``program.signature()``; a bare spec is
        wrapped with this pipeline's adc/enc).  Handles hold no weights:
        every call supplies them, so configurations sharing a signature share
        the executable."""
        if isinstance(program, FPCASpec):
            program = FPCAProgram(spec=program, adc=self.adc, enc=self.enc, out_channels=out_channels)
        elif out_channels is not None and int(out_channels) != int(program.out_channels):
            program = program.replace(out_channels=int(out_channels))
        key = program.signature()
        handle = self._handles.get(key)
        if handle is None:
            handle = CompiledFrontend(program, model=self._model_for(program), **self._handle_kw())
            self._handles[key] = handle
        return handle

    def model_handle_for(self, model: FPCAModelProgram) -> CompiledModel:
        """The shared :class:`repro_torch.fpca.CompiledModel` serving one
        model compile signature (same dict as the frontend handles: model
        signatures extend frontend ones, so the keys never collide).  Handles
        hold no parameters; every call supplies the NVM planes and head."""
        key = model.signature()
        handle = self._handles.get(key)
        if handle is None:
            handle = CompiledModel(model, model=self._model_for(model.frontend), **self._handle_kw())
            self._handles[key] = handle
        return handle  # type: ignore[return-value]

    def reset_bucket_state(self) -> None:
        """Forget all sticky row-bucket state (counters in ``stats`` remain)."""
        for handle in self._handles.values():
            handle.reset_bucket_state()

    # -- scheduling ----------------------------------------------------------
    def group_requests(self, requests: Sequence[FrontendRequest]) -> dict[str, list[int]]:
        """Request indices bucketed by configuration (insertion-ordered)."""
        groups: dict[str, list[int]] = {}
        for i, req in enumerate(requests):
            if req.config not in self._configs:
                raise KeyError(f"unknown config {req.config!r}")
            groups.setdefault(req.config, []).append(i)
        return groups

    def _run_batch(
        self,
        program: FPCAProgram,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None = None,
        *,
        handle: CompiledFrontend | None = None,
        head_params: Any | None = None,
    ) -> torch.Tensor:
        """One fused handle call.  Nothing is mirrored here: the handle's
        cells are parent-chained into ``self.stats``.  With a
        :class:`CompiledModel` ``handle`` and its ``head_params`` the call
        serves the head's raw outputs instead of SS-ADC counts."""
        if handle is None:
            handle = self.handle_for(program, int(kernel.shape[0]))
        if head_params is not None:
            return handle.run_weighted(kernel, bn_offset, images, window_keep, head_params=head_params)
        return handle.run_weighted(kernel, bn_offset, images, window_keep)

    def run_config_batch(
        self,
        name: str | Sequence[str],
        images: Any,
        window_keep: np.ndarray | None = None,
    ) -> torch.Tensor:
        """Non-blocking fused call for a frame batch of registered config(s).

        With one config name, returns ``(b, h_o, w_o, c_o)`` SS-ADC counts on
        the device, not waited on: the streaming server's double-buffered
        loop lives on this method.  Windows ``window_keep`` skips come back
        as exact zeros without having been computed.

        With a sequence of names (one camera feeding several programmed
        configurations), every named config must share the first one's
        :class:`FPCASpec`; their NVM planes are stacked along the channel
        axis and the fan-out runs as ONE fused call.  Returns ``(b, h_o, w_o,
        sum(c_o))``; :meth:`config_channel_slices` gives each config's range.
        """
        names = [name] if isinstance(name, str) else list(name)
        if not names:
            raise ValueError("need at least one config name")
        for n in names:
            if n not in self._configs:
                raise KeyError(f"unknown config {n!r}")
        cfgs = [self._configs[n] for n in names]
        spec = cfgs[0].spec
        for cfg in cfgs[1:]:
            if cfg.spec != spec:
                raise ValueError(
                    f"multi-config fan-out requires a shared spec: config "
                    f"{cfg.name!r} differs from {cfgs[0].name!r}"
                )
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        want = (spec.image_h, spec.image_w, spec.in_channels)
        if images.ndim != 4 or tuple(images.shape[1:]) != want:
            raise ValueError(
                f"expected (b, {want[0]}, {want[1]}, {want[2]}) batch for "
                f"config {names[0]!r}, got {tuple(images.shape)}"
            )
        if len(cfgs) == 1:
            cfg = cfgs[0]
            return self._run_batch(cfg.program, cfg.kernel, cfg.bn_offset, images, window_keep)
        kernel, bn, stacked_program = self._stacked_planes(names, cfgs)
        batches_before = self.stats.batches
        counts = self._run_batch(stacked_program, kernel, bn, images, window_keep)
        # a zero-kept tick short-circuits inside the handle: count only the
        # fan-outs that launched
        self.stats.fanout_batches += self.stats.batches - batches_before
        return counts

    def run_config_segment(
        self,
        name: str,
        frames: Any,
        *,
        state: Any | None = None,
        gate: Any = _USE_PROGRAM,
        m_bucket: int | None = None,
        early_exit: int | None = None,
    ) -> SegmentResult:
        """Serve K streaming ticks of one registered configuration as ONE
        segment (:meth:`repro_torch.fpca.CompiledFrontend.run_segment`: one
        CUDA graph replay on the card).  ``frames`` is ``(K, H, W, c_i)``;
        ``state`` threads the previous segment's state.  Model
        configurations serve per-tick logits through the skip-aware head.
        Handle counters land in ``stats`` through the parent chain."""
        cfg = self._configs.get(name)
        if cfg is None:
            raise KeyError(f"unknown config {name!r}")
        kwargs: dict[str, Any] = dict(state=state, gate=gate, m_bucket=m_bucket, early_exit=early_exit)
        if isinstance(cfg, ProgrammedModel):
            handle = self.model_handle_for(cfg.model)
            return handle.run_segment_weighted(
                cfg.kernel, cfg.bn_offset, frames, head_params=cfg.head_params, **kwargs
            )
        handle = self.handle_for(cfg.program, int(cfg.kernel.shape[0]))
        return handle.run_segment_weighted(cfg.kernel, cfg.bn_offset, frames, **kwargs)

    def _stacked_planes(
        self, names: Sequence[str], cfgs: Sequence[ProgrammedConfig | ProgrammedModel]
    ) -> tuple[torch.Tensor, torch.Tensor, FPCAProgram]:
        """Channel-stacked (kernel, bn, program) for one fan-out tuple,
        cached per tuple: the concat and the compatibility check (one
        stacked launch serves ONE adc/enc/circuit epilogue) are paid once."""
        key = tuple(names)
        stacked = self._stacked.get(key)
        if stacked is None:
            base = cfgs[0].program.fanout_signature()
            for cfg in cfgs[1:]:
                if cfg.program.fanout_signature() != base:
                    raise ValueError(
                        f"multi-config fan-out requires a shared spec and "
                        f"compile signature (adc/enc/circuit): config "
                        f"{cfg.name!r} differs from {cfgs[0].name!r}"
                    )
            kernel = torch.cat([c.kernel for c in cfgs], dim=0)
            stacked = self._stacked[key] = (
                kernel,
                torch.cat([c.bn_offset for c in cfgs], dim=0),
                cfgs[0].program.replace(out_channels=int(kernel.shape[0])),
            )
        return stacked

    def config_channel_slices(self, names: Sequence[str]) -> list[tuple[str, int, int]]:
        """Per-config ``(name, lo, hi)`` channel ranges of a stacked fan-out
        call (the order :meth:`run_config_batch` concatenates in)."""
        slices: list[tuple[str, int, int]] = []
        lo = 0
        for n in names:
            c_o = int(self._configs[n].kernel.shape[0])
            slices.append((n, lo, lo + c_o))
            lo += c_o
        return slices

    def _group_window_keep(
        self, cfg: ProgrammedConfig | ProgrammedModel, reqs: list[FrontendRequest]
    ) -> np.ndarray | None:
        """Stacked per-window keep grid for a request group (None = dense)."""
        if all(r.block_mask is None for r in reqs):
            return None
        h_o, w_o = output_dims(cfg.spec)
        return np.stack([
            active_window_mask(cfg.spec, r.block_mask) if r.block_mask is not None else np.ones((h_o, w_o), bool)
            for r in reqs
        ])

    def _check_geometry(self, name: str, requests: Sequence[FrontendRequest], idxs: list[int]) -> None:
        cfg = self._configs[name]
        want_shape = (cfg.spec.image_h, cfg.spec.image_w, cfg.spec.in_channels)
        for i in idxs:
            got = tuple(np.shape(requests[i].image))
            if got != want_shape:
                raise ValueError(
                    f"request {i}: frame shape {got} does not match config "
                    f"{name!r} sensor geometry {want_shape}"
                )

    def _stack_images(self, requests: Sequence[FrontendRequest], idxs: list[int]) -> torch.Tensor:
        """The group's frames as one ``(b, H, W, c_i)`` batch on the device:
        host frames are stacked on the host and copied once."""
        imgs = [requests[i].image for i in idxs]
        if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in imgs):
            return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=self.device) for x in imgs])
        return torch.as_tensor(np.stack([np.asarray(x, np.float32) for x in imgs]), device=self.device)

    def serve(self, requests: Sequence[FrontendRequest]) -> list[Any]:
        """Serve a mixed request mix; results in request order.

        Returns one SS-ADC count map ``(h_o, w_o, c_o)`` per request (a
        tensor on the device) or, for requests naming a model configuration,
        the ``(n_classes,)`` logits of the fused frontend+head call (a
        :class:`Detections` for a detection head).
        """
        with telemetry.span("serve"):
            results: list[Any] = [None] * len(requests)
            groups = self.group_requests(requests)
            self.stats.requests += len(requests)
            merged: dict[tuple, list[str]] = {}
            for name in groups:
                cfg = self._configs[name]
                key = cfg.program.signature() if self.cross_config_batching else (name,)
                merged.setdefault(key, []).append(name)
            for names in merged.values():
                if len(names) == 1:
                    self._submit_group(names[0], groups[names[0]], requests, results)
                else:
                    self._submit_merged(names, groups, requests, results)
            return results

    def submit(self, requests: Sequence[FrontendRequest]) -> list[Any]:
        """Deprecation shim for :meth:`serve`."""
        warnings.warn(
            "FPCAPipeline.submit is deprecated; use FPCAPipeline.serve "
            "(same semantics) or compile an explicit handle via "
            "repro.fpca.compile",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.serve(requests)

    def _submit_group(
        self, name: str, idxs: list[int], requests: Sequence[FrontendRequest], results: list
    ) -> None:
        cfg = self._configs[name]
        self._check_geometry(name, requests, idxs)
        images = self._stack_images(requests, idxs)
        window_keep = self._group_window_keep(cfg, [requests[i] for i in idxs])
        dc = None
        if isinstance(cfg, ProgrammedModel):
            # whole-model config: one fused frontend+head call -> logits
            counts = self._run_batch(
                cfg.program, cfg.kernel, cfg.bn_offset, images, window_keep,
                handle=self.model_handle_for(cfg.model), head_params=cfg.head_params,
            )
            dc = cfg.model.detect_classes
        else:
            counts = self._run_batch(cfg.program, cfg.kernel, cfg.bn_offset, images, window_keep)
        for j, i in enumerate(idxs):
            results[i] = Detections.from_raw(counts[j], dc) if dc is not None else counts[j]

    def _submit_merged(
        self,
        names: list[str],
        groups: dict[str, list[int]],
        requests: Sequence[FrontendRequest],
        results: list,
    ) -> None:
        """Cross-config batching: configs sharing a compile signature run as
        ONE call with their NVM planes stacked along the channel axis; each
        request's counts are sliced from its config's channel range.  Model
        configurations stack like frontend ones, then run their heads per
        config on their channel slice: each resolves to the logits of
        serving that config alone."""
        cfgs = [self._configs[n] for n in names]
        for name in names:
            self._check_geometry(name, requests, groups[name])
        kernel, bn, program = self._stacked_planes(names, cfgs)
        idxs = [i for n in names for i in groups[n]]
        images = self._stack_images(requests, idxs)
        window_keep = self._group_window_keep(cfgs[0], [requests[i] for i in idxs])
        counts = self._run_batch(program, kernel, bn, images, window_keep)
        self.stats.merged_groups += 1
        offsets = np.cumsum([0] + [int(c.kernel.shape[0]) for c in cfgs])
        row = 0
        for g, (name, cfg) in enumerate(zip(names, cfgs)):
            lo, hi = int(offsets[g]), int(offsets[g + 1])
            rows = groups[name]
            if isinstance(cfg, ProgrammedModel):
                handle = self.model_handle_for(cfg.model)
                logits = handle.head_logits(
                    counts[row : row + len(rows), ..., lo:hi],
                    head_params=cfg.head_params,
                )
                dc = cfg.model.detect_classes
                for j, i in enumerate(rows):
                    results[i] = Detections.from_raw(logits[j], dc) if dc is not None else logits[j]
                row += len(rows)
            else:
                for i in rows:
                    results[i] = counts[row, ..., lo:hi]
                    row += 1
