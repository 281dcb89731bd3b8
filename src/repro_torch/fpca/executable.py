"""``compile()``, :class:`CompiledFrontend` and :class:`CompiledModel` — the
explicit executable handles of the FPCA API::

    program = FPCAProgram(spec=FPCASpec(...))
    fe = fpca.compile(program)                     # on the card, "cuda" backend
    fe.reprogram(kernel)                           # cheap NVM rewrite
    counts = fe.run(batch)                         # one kernel launch
    fe.reprogram(other_kernel)                     # builds nothing new

``compile()`` fits (or accepts) the calibrated bucket model, resolves the
backend and device, and returns a handle that owns the bounded LRU of built
executables (:meth:`CompiledFrontend.cache_info`), the sticky region-skip
row buckets, batch padding and the executed-window accounting
(:attr:`CompiledFrontend.stats`).  Weights enter every executable as call
arguments while the cache key is the program's signature, so reprogramming
never builds an executable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.curvefit import BucketCurvefitModel, fit_bucket_model
from repro_torch.core.mapping import FPCASpec, active_window_mask, output_dims
from repro_torch.device import resolve_device
from repro_torch.fpca.backends import Backend, default_backend_name, get_backend
from repro_torch.fpca.cache import CacheInfo, CacheInfoVerbose, ExecutableCache
from repro_torch.fpca.program import FPCAModelProgram, FPCAProgram, _as_tensor
from repro_torch.kernels.fpca_conv.ops import StickyBucket
from repro_torch.models.heads import Detections
from repro_torch.training.tree import tree_map

__all__ = ["FrontendStats", "CompiledFrontend", "CompiledModel", "compile"]


@dataclasses.dataclass
class FrontendStats:
    """Per-handle serving counters (all monotonic).

    * ``runs``              — executable invocations
    * ``reprograms``        — weight rewrites
    * ``windows_total``     — windows submitted (incl. batch padding)
    * ``windows_executed``  — windows that reached the kernel (the row bucket
      on the region-skip path)
    * ``launches_skipped``  — all-skipped calls that launched no kernel
    * ``bucket_switches``   — served bucket-size transitions
    * ``bucket_shrinks_deferred`` — flap events sticky hysteresis absorbed
    * ``segments`` / ``segment_ticks`` — compiled streaming segments (a later
      slice of the port; zero here)
    """

    runs: int = 0
    reprograms: int = 0
    windows_total: int = 0
    windows_executed: int = 0
    launches_skipped: int = 0
    bucket_switches: int = 0
    bucket_shrinks_deferred: int = 0
    segments: int = 0
    segment_ticks: int = 0

    def snapshot(self) -> dict[str, int]:
        return dataclasses.asdict(self)


def _round_up_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _host_bool(x: Any) -> np.ndarray:
    """A writable host copy of a keep mask given as numpy or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.array(x, dtype=bool)


def _patch(device: torch.device, counts: Any, prev_eff: Any, window_keep: Any) -> torch.Tensor:
    """The effective activation map: kept windows from ``counts``, the rest
    from ``prev_eff``."""
    keep = _as_tensor(window_keep, torch.bool, device)
    return torch.where(
        keep[..., None], _as_tensor(counts, torch.float32, device), _as_tensor(prev_eff, torch.float32, device)
    )


class CompiledFrontend:
    """An explicitly-held FPCA executable: one program, one backend, one
    device, weights swappable without building anything.  Construct via
    :func:`compile`."""

    def __init__(
        self,
        program: FPCAProgram,
        *,
        backend: Backend,
        model: BucketCurvefitModel,
        device: torch.device,
        cache: ExecutableCache | None = None,
        cache_capacity: int = 8,
        bucket_patience: int = 1,
    ):
        if bucket_patience < 1:
            raise ValueError("bucket_patience must be >= 1")
        self.program = program
        self.backend = backend
        self.model = model
        self.device = device
        self.bucket_patience = bucket_patience
        self._cache = cache if cache is not None else ExecutableCache(cache_capacity)
        self._sig = program.signature()
        self._sticky: dict[int, StickyBucket] = {}   # keyed by padded window count
        self._kernel: torch.Tensor | None = None
        self._bn: torch.Tensor | None = None
        self.stats = FrontendStats()

    # -- introspection -------------------------------------------------------
    @property
    def spec(self) -> FPCASpec:
        return self.program.spec

    @property
    def out_channels(self) -> int:
        return int(self.program.out_channels)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return self.program.out_shape

    @property
    def kernel(self) -> torch.Tensor | None:
        """Currently programmed NVM weights (None until :meth:`reprogram`)."""
        return self._kernel

    @property
    def bn_offset(self) -> torch.Tensor | None:
        return self._bn

    def signature(self) -> tuple:
        return self._sig

    def cache_info(self, verbose: bool = False) -> CacheInfo | CacheInfoVerbose:
        """Executable-cache counters; ``misses`` counts executables built and
        must not move across :meth:`reprogram`."""
        return self._cache.info(verbose=verbose)

    def reset_bucket_state(self) -> None:
        """Forget sticky row-bucket state (counters in ``stats`` remain)."""
        self._sticky.clear()

    # -- programming ---------------------------------------------------------
    def reprogram(self, kernel: Any, bn_offset: Any | None = None) -> "CompiledFrontend":
        """Rewrite the NVM weight planes (and BN offsets).  Builds nothing:
        weights are call arguments of every executable.  Returns ``self``."""
        kernel = torch.as_tensor(kernel, dtype=torch.float32, device=self.device)
        want = self.program.kernel_shape
        if tuple(kernel.shape) != want:
            raise ValueError(
                f"kernel shape {tuple(kernel.shape)} does not match program kernel shape {want}"
            )
        if bn_offset is None:
            bn_offset = self._bn if self._bn is not None else torch.zeros(self.out_channels)
        bn_offset = torch.as_tensor(bn_offset, dtype=torch.float32, device=self.device)
        if tuple(bn_offset.shape) != (self.out_channels,):
            raise ValueError(f"bn_offset shape {tuple(bn_offset.shape)} != ({self.out_channels},)")
        self._kernel = kernel
        self._bn = bn_offset
        self.stats.reprograms += 1
        return self

    # -- execution -----------------------------------------------------------
    def run(
        self,
        images: Any,
        *,
        block_mask: np.ndarray | None = None,
        window_keep: np.ndarray | None = None,
    ) -> torch.Tensor:
        """Serve one frame ``(H, W, c_i)`` or batch ``(B, H, W, c_i)``.

        ``block_mask`` is the §3.4.5 per-block keep grid (one grid for every
        frame, or one per frame); ``window_keep`` the already-derived
        ``(B, h_o, w_o)`` window mask — pass at most one.  Skipped windows
        never reach the kernel and come back as exact zeros.  The result
        mirrors the input's batchedness.
        """
        kernel = self._require_weights()
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        squeeze = images.ndim == 3
        if squeeze:
            images = images[None]
        if block_mask is not None:
            if window_keep is not None:
                raise ValueError("pass block_mask or window_keep, not both")
            block_mask = _host_bool(block_mask)
            if block_mask.ndim == 2:
                keep = active_window_mask(self.spec, block_mask)
                window_keep = np.broadcast_to(keep, (images.shape[0],) + keep.shape)
            else:
                window_keep = np.stack([active_window_mask(self.spec, m) for m in block_mask])
        out = self.run_weighted(kernel, self._bn, images, window_keep)
        return out[0] if squeeze else out

    def run_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None = None,
    ) -> torch.Tensor:
        """One executable call with explicit weights: ``images`` is a
        ``(b, H, W, c_i)`` batch, ``window_keep`` an optional ``(b, h_o, w_o)``
        boolean grid.  The call is asynchronous on the device."""
        return self._dispatch_weighted(kernel, bn_offset, images, window_keep)

    def _dispatch_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None = None,
        *,
        executable_for: Callable | None = None,
        extra: tuple = (),
        empty: Callable | None = None,
    ) -> torch.Tensor:
        """Padding / bucketing / accounting engine behind every weighted call.

        ``executable_for(m_bucket)`` fetches the executable (default: the
        frontend's), ``extra`` is appended to its arguments before the
        window mask (head parameters), ``empty(b, h_o, w_o, c_o)`` produces
        the all-skipped result without a launch.
        """
        executable_for = executable_for or self._executable
        spec = self.spec
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        want = (spec.image_h, spec.image_w, spec.in_channels)
        if images.ndim != 4 or tuple(images.shape[1:]) != want:
            raise ValueError(
                f"expected (b, {want[0]}, {want[1]}, {want[2]}) batch, got {tuple(images.shape)}"
            )
        c_o = int(kernel.shape[0])
        if c_o != self.out_channels:
            raise ValueError(
                f"kernel has {c_o} output channels; this handle is compiled for {self.out_channels}"
            )
        b = images.shape[0]
        h_o, w_o = output_dims(spec)
        if window_keep is not None:
            window_keep = _host_bool(window_keep)
            if window_keep.shape != (b, h_o, w_o):
                raise ValueError(f"window_keep shape {window_keep.shape} != {(b, h_o, w_o)}")
        padded = _round_up_pow2(b)
        if padded > b:
            images = torch.cat([images, images.new_zeros((padded - b,) + tuple(images.shape[1:]))])
            if window_keep is not None:
                window_keep = np.concatenate([window_keep, np.zeros((padded - b, h_o, w_o), bool)])
        m_total = padded * h_o * w_o
        self.stats.windows_total += m_total
        if window_keep is None:
            self.stats.runs += 1
            self.stats.windows_executed += m_total
            return executable_for(None)(images, kernel, bn_offset, *extra)[:b]
        n_keep = int(np.count_nonzero(window_keep))
        if n_keep == 0:
            # all-skipped: the counts are exact zeros by contract, so nothing
            # launches; the sticky bucket still counts the tick as under-full
            self.stats.launches_skipped += 1
            sticky = self._sticky.get(m_total)
            if sticky is not None:
                sticky.observe_idle()
            if empty is not None:
                return empty(b, h_o, w_o, c_o)
            return torch.zeros((b, h_o, w_o, c_o), device=self.device)
        self.stats.runs += 1
        m_bucket = self._bucket_for(n_keep, m_total)
        self.stats.windows_executed += m_bucket
        mask = torch.as_tensor(window_keep, device=self.device)
        return executable_for(m_bucket)(images, kernel, bn_offset, *extra, mask)[:b]

    # -- internals -----------------------------------------------------------
    def _require_weights(self) -> torch.Tensor:
        if self._kernel is None:
            raise RuntimeError(
                "no weights programmed: call reprogram(kernel) first (or pass weights= to compile())"
            )
        return self._kernel

    def _frontend_transfer(self) -> str:
        """The bucket transfer the frontend executables serve: "int8" for a
        ``precision="int8"`` model program on a ``quant_transfer`` backend
        (so the frontend stage alone counts what the whole-model executable
        counts), "f32" everywhere else."""
        mp = getattr(self, "model_program", None)
        if mp is not None and mp.precision == "int8" and self.backend.quant_transfer:
            return "int8"
        return "f32"

    def _executable(self, m_bucket: int | None) -> Callable:
        # the dense oracle serves every bucket size with one executable
        if m_bucket is not None and not self.backend.bucket_sensitive:
            m_bucket = -1
        transfer = self._frontend_transfer()
        key = self._sig + (self.backend.name, m_bucket, transfer, str(self.device))

        def build() -> Callable:
            kw = {"transfer": transfer} if transfer != "f32" else {}
            return self.backend.make_executable(
                self.model, spec=self.spec, adc=self.program.adc, enc=self.program.enc,
                m_bucket=m_bucket, device=self.device, **kw,
            )

        return self._cache.get(key, build)

    def _bucket_for(self, n_keep: int, m_total: int) -> int:
        """Sticky row bucket for one window-count batch shape."""
        sticky = self._sticky.get(m_total)
        if sticky is None:
            sticky = self._sticky[m_total] = StickyBucket(self.bucket_patience)
        before = (sticky.switches, sticky.shrinks_deferred)
        m_bucket = sticky.bucket(n_keep, m_total)
        self.stats.bucket_switches += sticky.switches - before[0]
        self.stats.bucket_shrinks_deferred += sticky.shrinks_deferred - before[1]
        return m_bucket


class CompiledModel(CompiledFrontend):
    """An explicitly-held model executable: analog frontend + digital head.

    :meth:`run` returns class logits (or :class:`Detections` for a
    detection head) from one executable (frontend, then head);
    :meth:`reprogram` rewrites NVM planes and/or head parameters, neither
    of which builds anything.
    """

    def __init__(self, model_program: FPCAModelProgram, *, head_params: Any | None = None, **kw: Any):
        if not isinstance(model_program, FPCAModelProgram):
            raise TypeError(f"expected FPCAModelProgram, got {type(model_program)}")
        super().__init__(model_program.frontend, **kw)
        self.model_program = model_program
        self._model_sig = model_program.signature()
        self._head_params: Any | None = None
        # the zoo's stamp, a label only ("custom" off the registry)
        self.arch = model_program.arch or "custom"
        if head_params is not None:
            self.reprogram(head_params=head_params)

    # -- introspection -------------------------------------------------------
    @property
    def n_classes(self) -> int:
        return self.model_program.n_classes

    @property
    def head_out_shape(self) -> tuple[int, ...]:
        return self.model_program.head_out_shape

    @property
    def output_kind(self) -> str:
        return self.model_program.output_kind

    @property
    def detect_classes(self) -> int | None:
        return self.model_program.detect_classes

    @property
    def head_params(self) -> Any | None:
        """Currently programmed head parameters (None until programmed)."""
        return self._head_params

    def signature(self) -> tuple:
        """The MODEL signature (extends the frontend's)."""
        return self._model_sig

    def frontend_signature(self) -> tuple:
        return self._sig

    def reprogram(
        self,
        kernel: Any | None = None,
        bn_offset: Any | None = None,
        *,
        head_params: Any | None = None,
    ) -> "CompiledModel":
        """Rewrite NVM weight planes, BN offsets and/or the head parameters;
        any side may be updated alone.  Builds nothing."""
        if kernel is None and bn_offset is None and head_params is None:
            raise ValueError("reprogram needs kernel, bn_offset and/or head_params")
        if kernel is not None:
            super().reprogram(kernel, bn_offset)
        elif bn_offset is not None:
            super().reprogram(self._require_weights(), bn_offset)
        if head_params is not None:
            self._head_params = self.model_program.bind_head_params(head_params, device=self.device)
            if kernel is None and bn_offset is None:
                self.stats.reprograms += 1
        return self

    def _require_head(self) -> Any:
        if self._head_params is None:
            raise RuntimeError(
                "no head parameters programmed: call reprogram(head_params=...) first "
                "(or pass head_params= to compile())"
            )
        return self._head_params

    def run(
        self,
        images: Any,
        *,
        block_mask: np.ndarray | None = None,
        window_keep: np.ndarray | None = None,
    ) -> Any:
        """Serve one frame or batch through the whole-model executable:
        logits ``(n_classes,)`` / ``(B, n_classes)``, or
        :class:`Detections` split from the raw per-cell maps of a detection
        head."""
        out = super().run(images, block_mask=block_mask, window_keep=window_keep)
        dc = self.detect_classes
        if dc is not None:
            return Detections.from_raw(out, dc)
        return out

    def run_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None = None,
        *,
        head_params: Any | None = None,
    ) -> torch.Tensor:
        """One frontend+head call -> ``(b,) + head_out_shape`` raw outputs
        (logits, or per-cell detection maps that :meth:`run` splits).  An
        all-skipped batch launches no kernel and serves the head on the
        exact-zero activation map."""
        hp = self._require_head() if head_params is None else head_params

        def empty(b: int, h_o: int, w_o: int, c_o: int) -> torch.Tensor:
            return self.head_logits(torch.zeros((b, h_o, w_o, c_o), device=self.device), hp)

        return self._dispatch_weighted(
            kernel, bn_offset, images, window_keep,
            executable_for=self._model_executable, extra=(hp,), empty=empty,
        )

    def run_frontend_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None = None,
    ) -> torch.Tensor:
        """The frontend stage alone (SS-ADC counts); its executables are
        keyed by the frontend signature, shared with frontend handles."""
        return self._dispatch_weighted(kernel, bn_offset, images, window_keep)

    def head_logits(self, counts: Any, head_params: Any | None = None) -> torch.Tensor:
        """Digital head on an explicit activation map."""
        hp = self._require_head() if head_params is None else head_params
        counts = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        return self.model_program.apply_head(hp, counts)

    def patched_logits(
        self,
        counts: Any,
        prev_eff: Any,
        window_keep: Any,
        head_params: Any | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Skip-aware head step: patch the kept windows of ``counts`` into
        ``prev_eff`` and run the head on the patched map.  Returns
        ``(logits, effective)``; callers carry ``effective`` forward as the
        next tick's ``prev_eff``."""
        hp = self._require_head() if head_params is None else head_params
        eff = _patch(self.device, counts, prev_eff, window_keep)
        return self.model_program.apply_head(hp, eff), eff

    def fused_patched_logits(
        self,
        head_params_rows: Any,
        counts: Any,
        prev_eff: Any,
        window_keep: Any,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Shared-head fusion: one patch+head pass over stacked rows, each
        row binding its own head parameters (``head_params_rows`` is the
        per-row stack, leading axis == ``counts.shape[0]``).

        Row for row bit-identical to :meth:`patched_logits` on that row:
        each row runs the head at batch 1, as a per-row call does (a
        batched conv or GEMM may sum in another order)."""
        eff = _patch(self.device, counts, prev_eff, window_keep)
        head = self.model_program.apply_head
        rows = [
            head(tree_map(lambda a, i=i: a[i], head_params_rows), eff[i : i + 1])[0]
            for i in range(eff.shape[0])
        ]
        return torch.stack(rows), eff

    def _model_executable(self, m_bucket: int | None) -> Callable:
        if m_bucket is not None and not self.backend.bucket_sensitive:
            m_bucket = -1
        key = self._model_sig + (self.backend.name, "model", m_bucket, str(self.device))

        def build() -> Callable:
            return self.backend.make_model_executable(
                self.model_program, self.model, m_bucket=m_bucket, device=self.device
            )

        return self._cache.get(key, build)


def compile(  # noqa: A001  (torch.compile-style public name)
    program: FPCAProgram | FPCAModelProgram | FPCASpec,
    *,
    backend: str | Backend | None = None,
    device: str | torch.device | None = None,
    weights: Any | None = None,
    bn_offset: Any | None = None,
    head_params: Any | None = None,
    model: BucketCurvefitModel | None = None,
    cache: ExecutableCache | None = None,
    cache_capacity: int = 8,
    bucket_patience: int = 1,
) -> CompiledFrontend:
    """Compile a program into a held executable handle.

    Args:
      program: an :class:`FPCAProgram` (or a bare :class:`FPCASpec`), or an
        :class:`FPCAModelProgram`, which yields a :class:`CompiledModel`.
      backend: registered backend name or instance; default ``"cuda"`` on the
        card and ``"basis"`` on the host.
      device: where the handle runs; the CUDA card by default (raises when
        there is none — pass ``device="cpu"`` to run on the host).
      weights / bn_offset / head_params: program the weights immediately.
      model: fitted bucket model; fitted on ``device`` from
        ``program.circuit`` when omitted.
      cache: share one bounded :class:`ExecutableCache` across handles;
        a private cache of ``cache_capacity`` otherwise.
      bucket_patience: sticky-bucket hysteresis for region-skip row buckets
        (``1`` = stateless).
    """
    if isinstance(program, FPCASpec):
        program = FPCAProgram(spec=program)
    is_model = isinstance(program, FPCAModelProgram)
    if not is_model and not isinstance(program, FPCAProgram):
        raise TypeError(f"expected FPCAProgram, FPCAModelProgram or FPCASpec, got {type(program)}")
    if head_params is not None and not is_model:
        raise ValueError("head_params= needs an FPCAModelProgram")
    dev = resolve_device(device)
    frontend = program.frontend if is_model else program
    be = get_backend(backend if backend is not None else default_backend_name(dev))
    if model is None:
        model = fit_bucket_model(frontend.circuit, n_pixels=frontend.spec.n_active_pixels, device=dev)
    common = dict(
        backend=be, model=model, device=dev, cache=cache,
        cache_capacity=cache_capacity, bucket_patience=bucket_patience,
    )
    handle: CompiledFrontend
    if is_model:
        handle = CompiledModel(program, head_params=head_params, **common)
    else:
        handle = CompiledFrontend(program, **common)
    if weights is not None:
        handle.reprogram(weights, bn_offset)
    return handle
