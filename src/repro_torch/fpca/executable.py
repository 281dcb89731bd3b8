"""``compile()``, :class:`CompiledFrontend` and :class:`CompiledModel` — the
explicit executable handles of the FPCA API::

    program = FPCAProgram(spec=FPCASpec(...))
    fe = fpca.compile(program)                     # on the card, "cuda" backend
    fe.reprogram(kernel)                           # cheap NVM rewrite
    counts = fe.run(batch)                         # one kernel launch
    fe.reprogram(other_kernel)                     # builds nothing new
    for result in fe.stream(frames):               # delta-gated, per tick
        ...
    seg = fe.run_segment(frames[:32])              # 32 ticks, one CUDA graph

``compile()`` fits (or accepts) the calibrated bucket model, resolves the
backend and device, and returns a handle that owns the bounded LRU of built
executables (:meth:`CompiledFrontend.cache_info`), the sticky region-skip
row buckets, batch padding and the executed-window accounting
(:attr:`CompiledFrontend.stats`).  Weights enter every executable as call
arguments while the cache key is the program's signature, so reprogramming
never builds an executable.

With ``mesh=`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`, e.g.
:func:`repro_torch.launch.mesh.make_host_mesh`) batches are data-parallel:
the padded batch splits over the mesh's data axes, every rank runs its
contiguous rows through the same executable and the results are
all-gathered, so every rank returns the whole batch, equal bit for bit to
an unmeshed call (a gather copies, it sums nothing).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gating
from repro_torch.core.curvefit import BucketCurvefitModel, fit_bucket_model
from repro_torch.core.mapping import FPCASpec, active_window_mask, output_dims
from repro_torch.device import resolve_device
from repro_torch.fpca import telemetry
from repro_torch.fpca.backends import Backend, default_backend_name, get_backend
from repro_torch.fpca.cache import CacheInfo, CacheInfoVerbose, ExecutableCache
from repro_torch.fpca.program import FPCAModelProgram, FPCAProgram, _as_tensor
from repro_torch.kernels.fpca_conv.ops import StickyBucket, segment_bucket
from repro_torch.models.heads import Detections
from repro_torch.training.tree import tree_map

__all__ = [
    "FrontendStats",
    "SegmentState",
    "SegmentResult",
    "CompiledFrontend",
    "CompiledModel",
    "compile",
]

_USE_PROGRAM = object()   # stream() / run_segment() sentinel: "inherit from program"

# Model-side workload accounting per zoo architecture (the ``arch`` stamp on
# FPCAModelProgram; "custom" for hand-rolled programs): process-wide
# labelled families in the telemetry registry.
_C_MODEL_RUNS = telemetry.registry().counter(
    "fpca_model_runs_total",
    "model-side executable dispatches (fused, patched or segment)",
    ("arch",), max_label_sets=64,
)
_C_MODEL_FRAMES = telemetry.registry().counter(
    "fpca_model_frames_total",
    "frames/ticks served by model-side dispatches",
    ("arch",), max_label_sets=64,
)
# the ``run_segment`` span's fields, by whether a head runs in the segment
_SEGMENT_FIELDS = {False: {"model": False}, True: {"model": True}}


class FrontendStats(telemetry.StatsView):
    """Per-handle serving counters (all monotonic), views over
    :mod:`repro_torch.fpca.telemetry` registry cells.

    * ``runs``              — executable invocations
    * ``reprograms``        — weight rewrites
    * ``windows_total``     — windows submitted (incl. batch padding)
    * ``windows_executed``  — windows that reached the kernel (the row bucket
      on the region-skip path)
    * ``launches_skipped``  — all-skipped ticks that launched no kernel
      (per-tick short-circuits and zero-kept ticks inside segments)
    * ``bucket_switches``   — served bucket-size transitions
    * ``bucket_shrinks_deferred`` — flap events sticky hysteresis absorbed
    * ``segments``          — segment launches
    * ``segment_ticks``     — ticks served from inside those launches

    Constructed with a ``parent`` view (an
    :class:`repro_torch.serving.fpca_pipeline.PipelineStats`), the cells
    chain into the parent's same-named cells (``runs`` into ``batches``), so
    every increment lands in one place.
    """

    _PREFIX = "fpca_frontend"
    # a handle run is one pipeline batch; reprograms stay per handle
    _PARENT_MAP = {"runs": "batches", "reprograms": None}
    _FIELDS = (
        "runs",
        "reprograms",
        "windows_total",
        "windows_executed",
        "launches_skipped",
        "bucket_switches",
        "bucket_shrinks_deferred",
        "segments",
        "segment_ticks",
    )


@dataclasses.dataclass
class SegmentState:
    """Carry threaded between :meth:`CompiledFrontend.run_segment` calls.

    The first four fields are the delta-gate state on the device
    (:class:`repro_torch.core.gating.GateCarry`); model segments add the
    effective activation map and the previous logits.  ``suggested_bucket``
    is a host-side hint: the compacted-row bucket the finished segment's kept
    counts size for the next one
    (:func:`repro_torch.kernels.fpca_conv.ops.segment_bucket`).  Thread the
    ``state`` of one :class:`SegmentResult` into the next call.
    """

    has_prev: Any
    prev_eff: Any
    age: Any
    frame_idx: Any
    eff: Any | None = None           # model segments: effective activation map
    logits: Any | None = None        # model segments: previous logits
    suggested_bucket: int | None = None

    def carry(self, model: bool, device: torch.device) -> tuple:
        """The carry tuple on ``device`` (tensors, or numpy from the
        reference's state through :func:`repro_torch.convert.segment_state_from_numpy`)."""
        c = (
            torch.as_tensor(self.has_prev, dtype=torch.bool, device=device),
            torch.as_tensor(self.prev_eff, dtype=torch.float32, device=device),
            torch.as_tensor(self.age, dtype=torch.int32, device=device),
            torch.as_tensor(self.frame_idx, dtype=torch.int32, device=device),
        )
        if model:
            if self.eff is None or self.logits is None:
                raise ValueError(
                    "model segment needs a state carrying (eff, logits) — "
                    "thread the state a CompiledModel.run_segment returned"
                )
            c += (
                torch.as_tensor(self.eff, dtype=torch.float32, device=device),
                torch.as_tensor(self.logits, dtype=torch.float32, device=device),
            )
        return c


@dataclasses.dataclass
class SegmentResult:
    """Outputs of one streaming segment.

    Per-tick arrays span the full segment ``length`` K; with early exit only
    the first ``ticks`` entries are meaningful (``counts`` past ``ticks``
    are zeros, ``kept_windows`` zeros, masks False).  ``counts`` (and
    ``logits``) stay tensors on the handle's device; the small per-tick
    bookkeeping arrays are realised on the host for the stats and the
    boundary servo.
    """

    counts: Any                      # (K, h_o, w_o, c_o) tensor on the device
    block_masks: np.ndarray          # (K, bh, bw) bool
    kept_windows: np.ndarray         # (K,) int
    keyframes: np.ndarray            # (K,) bool
    rows_executed: np.ndarray        # (K,) int: the rows the reference's branches bill
    ticks: int                       # ticks executed (K, or fewer with early exit)
    length: int                      # segment length K
    first_frame_idx: int             # stream frame index of tick 0
    gated: bool
    state: SegmentState
    logits: Any | None = None        # model segments: (K,) + head_out_shape
    detect_classes: int | None = None  # detection segments: class count

    def detections(self) -> list:
        """Per-tick :class:`Detections` of a detection segment (the first
        ``ticks`` entries, on the host; raises for classifier segments)."""
        if self.detect_classes is None:
            raise ValueError("not a detection segment: this model's head emits logits")
        raw = _host(self.logits)[: self.ticks]
        return [Detections.from_raw(r, self.detect_classes) for r in raw]


def _round_up_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    :func:`compile`.  :meth:`stream` serves a camera tick by tick;
    :meth:`run_segment` serves K ticks in one call (one CUDA graph replay on
    the card)."""

    def __init__(
        self,
        program: FPCAProgram,
        *,
        backend: Backend,
        model: BucketCurvefitModel,
        device: torch.device,
        mesh: Any | None = None,
        cache: ExecutableCache | None = None,
        cache_capacity: int = 8,
        bucket_patience: int = 1,
        stats_parent: telemetry.StatsView | None = None,
    ):
        if bucket_patience < 1:
            raise ValueError("bucket_patience must be >= 1")
        if mesh is not None and mesh.device_type != device.type:
            raise ValueError(f"mesh is on {mesh.device_type!r} devices, the handle on {device}")
        self.program = program
        self.backend = backend
        self.model = model
        self.device = device
        self.mesh = mesh
        # the data axes' process group and this rank's place in it, read once
        self._data_group = None
        if mesh is not None:
            from repro_torch.launch.mesh import data_group

            self._data_group = data_group(mesh)
        self.bucket_patience = bucket_patience
        self._cache = cache if cache is not None else ExecutableCache(cache_capacity)
        self._sig = program.signature()
        self._sticky: dict[int, StickyBucket] = {}   # keyed by padded window count
        self._kernel: torch.Tensor | None = None
        self._bn: torch.Tensor | None = None
        # parent-chained when a pipeline owns the handle: shared-name fields
        # (windows_executed, launches_skipped, ...) single-source into the
        # pipeline's PipelineStats cells
        self.stats = FrontendStats(parent=stats_parent)

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
        with telemetry.span("reprogram"):
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
        with telemetry.span("run"):
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
        with telemetry.layer("prepare"):
            run, images, mask, b = self._prepare_weighted(kernel, images, window_keep, executable_for)
        if run is None:
            # all-skipped: the counts are exact zeros by contract, so nothing
            # launches
            h_o, w_o = output_dims(self.spec)
            if empty is not None:
                return empty(b, h_o, w_o, self.out_channels)
            return torch.zeros((b, h_o, w_o, self.out_channels), device=self.device)
        return self._run_sharded(run, images, (kernel, bn_offset, *extra), mask)[:b]

    def _prepare_weighted(
        self,
        kernel: torch.Tensor,
        images: Any,
        window_keep: np.ndarray | None,
        executable_for: Callable,
    ) -> tuple[Callable | None, torch.Tensor, torch.Tensor | None, int]:
        """Validation, padding, the host mask, the bucket and the accounting
        of one weighted call: ``(executable, padded images, device mask,
        batch)``, the executable None when every window is skipped."""
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
        padded = self._padded_batch(b)
        if padded > b:
            images = torch.cat([images, images.new_zeros((padded - b,) + tuple(images.shape[1:]))])
            if window_keep is not None:
                window_keep = np.concatenate([window_keep, np.zeros((padded - b, h_o, w_o), bool)])
        m_total = padded * h_o * w_o
        self.stats.windows_total += m_total
        if window_keep is None:
            self.stats.runs += 1
            self.stats.windows_executed += m_total
            return executable_for(None), images, None, b
        n_keep = int(np.count_nonzero(window_keep))
        if n_keep == 0:
            # the sticky bucket still counts the tick as under-full
            self.stats.launches_skipped += 1
            sticky = self._sticky.get(m_total)
            if sticky is not None:
                sticky.observe_idle()
            return None, images, None, b
        self.stats.runs += 1
        m_bucket = self._bucket_for(n_keep, m_total)
        self.stats.windows_executed += m_bucket
        mask = torch.as_tensor(window_keep, device=self.device)
        return executable_for(m_bucket), images, mask, b

    # -- streaming -------------------------------------------------------------
    def stream(
        self,
        frames: Iterable[Any],
        *,
        gate: Any = _USE_PROGRAM,
        controller: Any = _USE_PROGRAM,
        depth: int = 2,
        stream_id: str = "stream0",
    ) -> Iterator[Any]:
        """Serve a continuous frame stream through this handle, tick by tick.

        Each frame steps a temporal delta gate (default ``program.gate``;
        ``gate=None`` reads densely even on a gated program), optionally
        servoed by a closed-loop threshold controller (default
        ``program.controller``; ``None`` disables); the keep mask is
        compacted in the kernel path.  Up to ``depth`` ticks stay in flight
        (the device work is asynchronous; the gate is not), and results
        yield in frame order as
        :class:`repro_torch.serving.streaming.StreamFrameResult`.
        """
        from repro_torch.serving.control import GateController
        from repro_torch.serving.streaming import StreamFrameResult, StreamSession

        if depth < 1:
            raise ValueError("depth must be >= 1")
        gate = self.program.gate if gate is _USE_PROGRAM else gate
        cconf = self.program.controller if controller is _USE_PROGRAM else controller
        ctl = (
            GateController(cconf, self.spec, gate.threshold, name=stream_id)
            if (cconf is not None and gate is not None)
            else None
        )
        session = StreamSession(stream_id, "__compiled__", self.spec, gate, controller=ctl, device=self.device)
        self._stream_session = session   # introspectable (controller history)
        h_o, w_o = output_dims(self.spec)

        def _finalize(entry: dict):
            return StreamFrameResult(
                stream_id=stream_id,
                frame_idx=entry["frame_idx"],
                counts=_host(entry["counts"])[0],
                block_mask=entry["block_mask"],
                kept_windows=entry["kept"],
                total_windows=h_o * w_o,
                config="__compiled__",
                **self._stream_extra_results(entry),
            )

        inflight: collections.deque[dict] = collections.deque()
        state: dict = {}   # per-iterator stream state (a model's effective map)
        span_fields = {"stream": stream_id}
        for frame in frames:
            with telemetry.span("serve_tick", span_fields):
                frame = np.asarray(_host(frame), np.float32)
                frame_idx = session.frame_idx
                block = session.step(frame)
                window = session.last_window_mask if gate is not None else None
                kept = int(window.sum()) if window is not None else h_o * w_o
                entry = {"frame_idx": frame_idx, "block_mask": block, "kept": kept}
                entry.update(self._stream_launch(frame, window, state))
            inflight.append(entry)
            while len(inflight) > depth:
                yield _finalize(inflight.popleft())
        while inflight:
            yield _finalize(inflight.popleft())

    def _stream_launch(self, frame: np.ndarray, window: np.ndarray | None, state: dict) -> dict:
        """Dispatch one stream tick; returns the entry's fields.  ``state`` is
        private to one ``stream()`` iterator."""
        counts = self.run_weighted(
            self._require_weights(), self._bn, frame[None], None if window is None else window[None]
        )
        return {"counts": counts}

    def _stream_extra_results(self, entry: dict) -> dict:
        """Extra ``StreamFrameResult`` fields realised from a tick entry."""
        return {}

    # -- segments ----------------------------------------------------------------
    def run_segment(
        self,
        frames: Any,
        *,
        length: int | None = None,
        state: SegmentState | None = None,
        gate: Any = _USE_PROGRAM,
        m_bucket: int | None = None,
        early_exit: int | None = None,
        donate: bool | None = None,
    ) -> SegmentResult:
        """Serve ``K`` streaming ticks in one call: the per-tick loop of
        :meth:`stream` (delta gate, hysteresis ages, keyframe cadence,
        kept-window compaction, the zero-kept short-circuit) as one tick body
        run K times, captured as one CUDA graph on the card
        (:meth:`repro_torch.fpca.Backend.make_segment_executable`).  Outputs
        are bit-identical, tick for tick, to :meth:`stream` on the same
        device.

        Args:
          frames: ``(K, H, W, c_i)`` stack; ``K`` is fixed per executable,
            so serve a stream in fixed-length chunks.
          length: optional check that ``K`` is the planned segment length.
          state: the previous segment's :attr:`SegmentResult.state`; ``None``
            starts a fresh stream (the first tick keyframes).
          gate: ``DeltaGateConfig`` for this segment (default: the
            program's; ``None`` = dense readout).  Its knobs are data: a
            servo retunes them between segments without building anything.
          m_bucket: the compacted-row bucket the host accounting bills for
            non-keyframe ticks (busier ticks bill M).  Default: the state's
            ``suggested_bucket``, M for the first segment.  On the device
            every tick walks exactly its kept rows.
          early_exit: stop after this many consecutive all-skipped ticks;
            ``result.ticks`` says how far the segment got.
          donate: accepted for the reference's signature; the carry is
            always copied into the executable's own buffers, so the given
            state stays valid.
        """
        return self.run_segment_weighted(
            self._require_weights(), self._bn, frames,
            length=length, state=state, gate=gate, m_bucket=m_bucket,
            early_exit=early_exit, donate=donate,
        )

    def run_segment_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        frames: Any,
        *,
        length: int | None = None,
        state: SegmentState | None = None,
        gate: Any = _USE_PROGRAM,
        m_bucket: int | None = None,
        early_exit: int | None = None,
        donate: bool | None = None,
    ) -> SegmentResult:
        """:meth:`run_segment` with explicit weights (they are data: a
        ``reprogram`` between segments builds nothing)."""
        return self._dispatch_segment(
            kernel, bn_offset, frames, length=length, state=state, gate=gate,
            m_bucket=m_bucket, early_exit=early_exit, donate=donate, head_params=None,
        )

    def _dispatch_segment(self, *args: Any, **kwargs: Any) -> SegmentResult:
        with telemetry.span("run_segment", _SEGMENT_FIELDS[kwargs.get("head_params") is not None]):
            return self._dispatch_segment_inner(*args, **kwargs)

    def _dispatch_segment_inner(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        frames: Any,
        *,
        length: int | None,
        state: SegmentState | None,
        gate: Any,
        m_bucket: int | None,
        early_exit: int | None,
        donate: bool | None,
        head_params: Any | None,
    ) -> SegmentResult:
        spec = self.spec
        # on the card the segment's graph stages the frames wherever they are
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device if self.device.type == "cpu" else None)
        want = (spec.image_h, spec.image_w, spec.in_channels)
        if frames.ndim != 4 or tuple(frames.shape[1:]) != want:
            raise ValueError(
                f"expected (K, {want[0]}, {want[1]}, {want[2]}) frame stack, got {tuple(frames.shape)}"
            )
        K = int(frames.shape[0])
        if K < 1:
            raise ValueError("need at least one frame")
        if length is not None and int(length) != K:
            raise ValueError(f"length={length} does not match the {K}-frame stack")
        c_o = int(kernel.shape[0])
        if c_o != self.out_channels:
            raise ValueError(
                f"kernel has {c_o} output channels; this handle is compiled for {self.out_channels}"
            )
        gate = self.program.gate if gate is _USE_PROGRAM else gate
        gated = gate is not None
        h_o, w_o = output_dims(spec)
        M = h_o * w_o
        bh, bw = gating.block_grid(spec)
        is_model = head_params is not None
        if gated:
            if m_bucket is None:
                m_bucket = state.suggested_bucket if state is not None and state.suggested_bucket else M
            m_bucket = max(1, min(int(m_bucket), M))
        else:
            m_bucket = None
        if early_exit is not None:
            early_exit = int(early_exit)
            if early_exit < 1:
                raise ValueError("early_exit patience must be >= 1")
            if not gated:
                raise ValueError("early_exit requires a gated segment")
        if donate is None:
            donate = self.device.type != "cpu"
        run = self._segment_executable(K, m_bucket, gated, early_exit, bool(donate), model=is_model)
        if state is None:
            state = self._fresh_segment_state(gate.hysteresis if gated else 0, is_model)
        first_idx = int(state.frame_idx)
        gate_args = None
        if gated:
            gate_args = (
                torch.tensor(gate.threshold, dtype=torch.float32),
                torch.tensor(gate.hysteresis, dtype=torch.int32),
                torch.tensor(gate.keyframe_interval, dtype=torch.int32),
            )
        outs, new_carry = run(frames, kernel, bn_offset, head_params, gate_args, state.carry(is_model, self.device))
        # the per-tick bookkeeping is realised here (it feeds the stats and
        # the boundary servo); counts and logits stay on the device
        with telemetry.layer("segment.wait"):
            ticks = int(outs["ticks"])
        with telemetry.layer("segment.realise"):
            if gated:
                kept = _host(outs["kept"]).astype(np.int64)
                keyframes = _host(outs["keyframe"]).astype(bool)
                block_masks = _host(outs["block_keep"]).astype(bool)
                rows = np.where(kept == 0, 0, np.where(kept > m_bucket, M, m_bucket))
                rows[ticks:] = 0
                suggested = segment_bucket(kept[:ticks], M, keyframes[:ticks])
            else:
                kept = np.full(K, M, np.int64)
                keyframes = np.zeros(K, bool)
                block_masks = np.ones((K, bh, bw), bool)
                rows = np.full(K, M, np.int64)
                suggested = None
            new_state = SegmentState(*new_carry[:4])
            if is_model:
                new_state.eff, new_state.logits = new_carry[4], new_carry[5]
            new_state.suggested_bucket = suggested
            self.stats.runs += 1
            self.stats.segments += 1
            self.stats.segment_ticks += ticks
            self.stats.windows_total += ticks * M
            self.stats.windows_executed += int(rows[:ticks].sum())
            if gated:
                self.stats.launches_skipped += int((kept[:ticks] == 0).sum())
            return SegmentResult(
                counts=outs["counts"],
                block_masks=block_masks,
                kept_windows=kept,
                keyframes=keyframes,
                rows_executed=rows,
                ticks=ticks,
                length=K,
                first_frame_idx=first_idx,
                gated=gated,
                state=new_state,
                logits=outs.get("logits"),
                detect_classes=self.model_program.detect_classes if is_model else None,
            )

    def _fresh_segment_state(self, hysteresis: int, is_model: bool) -> SegmentState:
        st = SegmentState(*gating.init_gate_carry(self.spec, hysteresis, self.device))
        if is_model:
            h_o, w_o = output_dims(self.spec)
            st.eff = torch.zeros((h_o, w_o, self.out_channels), device=self.device)
            st.logits = torch.zeros(self.model_program.head_out_shape, device=self.device)
        return st

    def _segment_executable(
        self,
        K: int,
        m_bucket: int | None,
        gated: bool,
        early_exit: int | None,
        donate: bool,
        *,
        model: bool = False,
    ) -> Callable:
        mb_key = m_bucket
        if mb_key is not None and not self.backend.bucket_sensitive:
            mb_key = -1
        key = self.signature() + (
            self.backend.name, "segment", K, mb_key, gated, early_exit, donate, model, str(self.device),
        )

        def build() -> Callable:
            return self.backend.instrumented(
                self.backend.make_segment_executable(
                    self.model,
                    spec=self.spec,
                    adc=self.program.adc,
                    enc=self.program.enc,
                    device=self.device,
                    length=K,
                    gated=gated,
                    m_bucket=m_bucket,
                    model_program=self.model_program if model else None,
                    early_exit=early_exit,
                    donate=donate,
                ),
                site="segment",
            )

        return self._cache.get(key, build)

    @property
    def data_parallelism(self) -> int:
        """Ranks the fused batch shards over (1 = unsharded single device).

        The batch-carrying extent of the mesh — what :meth:`_padded_batch`
        rounds the launch up to.  Gate state never shards: every rank keeps
        its own per stream."""
        if self.mesh is None:
            return 1
        from repro_torch.launch.mesh import data_extent

        return data_extent(self.mesh)

    # -- internals -----------------------------------------------------------
    def _padded_batch(self, b: int) -> int:
        """The pow-2 bucket of ``b``, rounded up to the data extent."""
        padded = _round_up_pow2(b)
        n_data = self.data_parallelism
        return -(-padded // n_data) * n_data

    def _shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a padded batch (all of it without
        a mesh)."""
        if self.mesh is None:
            return x
        _, rank = self._data_group
        per = x.shape[0] // self.data_parallelism
        return x[rank * per : (rank + 1) * per]

    def _run_sharded(self, run: Callable, images: torch.Tensor, args: tuple,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
        """``run`` on this rank's rows of the padded batch, the results
        all-gathered over the mesh's data group (in rank order: the whole
        batch).  The gather runs even on a one-rank mesh, as a many-rank
        job runs it."""
        if self.mesh is None:
            return run(images, *args) if mask is None else run(images, *args, mask)
        group, _ = self._data_group
        local = self._shard_batch(images)
        out = run(local, *args) if mask is None else run(local, *args, self._shard_batch(mask))
        full = out.new_empty((images.shape[0],) + tuple(out.shape[1:]))
        dist.all_gather_into_tensor(full, out.contiguous(), group=group)
        return full

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
            return self.backend.instrumented(
                self.backend.make_executable(
                    self.model, spec=self.spec, adc=self.program.adc, enc=self.program.enc,
                    m_bucket=m_bucket, device=self.device, **kw,
                ),
                site="frontend",
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
    of which builds anything.  :meth:`stream` and :meth:`run_segment` are
    skip-aware: each gated tick patches the kept-window activations into
    the previous effective activation map and runs the head on the patched
    map, so an all-skipped tick reproduces the previous logits exactly.
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
        self._m_runs = _C_MODEL_RUNS.labels(arch=self.arch)
        self._m_frames = _C_MODEL_FRAMES.labels(arch=self.arch)
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
            if kernel is None and bn_offset is None:
                # a head-only rewrite: the base reprogram (and its span) did
                # not run, so count and trace it here
                with telemetry.span("reprogram"):
                    self._head_params = self.model_program.bind_head_params(head_params, device=self.device)
                    self.stats.reprograms += 1
            else:
                self._head_params = self.model_program.bind_head_params(head_params, device=self.device)
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
        self._m_runs.add(1)
        self._m_frames.add(int(np.shape(images)[0]))

        def empty(b: int, h_o: int, w_o: int, c_o: int) -> torch.Tensor:
            return self.model_program.apply_head(hp, torch.zeros((b, h_o, w_o, c_o), device=self.device))

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
        """Digital head on an explicit ``(b, h, w, c)`` activation map.  The
        batch is zero-padded to the power of two that :meth:`run` pads the
        same batch to: at the same shape a GEMM or convolution sums in the
        same order, so ``head_logits(counts)`` equals the head of a fused
        call on those counts bit for bit."""
        hp = self._require_head() if head_params is None else head_params
        self._m_runs.add(1)
        counts = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        b = counts.shape[0]
        pad = _round_up_pow2(b) - b
        counts = torch.cat([counts, counts.new_zeros((pad,) + tuple(counts.shape[1:]))]) if pad else counts.contiguous()
        return self._head_executable()(hp, counts)[:b]

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
        next tick's ``prev_eff``.  Each row runs the head at batch 1, as
        :meth:`stream` and a segment do: a batched conv or GEMM may sum in
        another order, and a row's logits must not depend on the rows it
        rides with (a server's camera equals the camera served alone)."""
        hp = self._require_head() if head_params is None else head_params
        self._m_runs.add(1)
        self._m_frames.add(int(np.shape(counts)[0]))
        return self._patch_executable()(hp, counts, prev_eff, window_keep)

    def fused_patched_logits(
        self,
        head_params_rows: Any,
        counts: Any,
        prev_eff: Any,
        window_keep: Any,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Shared-head fusion: one patch+head pass over stacked rows, each
        row binding its own head parameters (``head_params_rows`` is the
        per-row stack, leading axis == ``counts.shape[0]``).  Row for row
        bit-identical to :meth:`patched_logits` on that row."""
        self._m_runs.add(1)
        self._m_frames.add(int(np.shape(counts)[0]))
        return self._fused_patch_executable()(head_params_rows, counts, prev_eff, window_keep)

    def _head_by_row(self, params_for_row: Callable, eff: torch.Tensor) -> torch.Tensor:
        head = self.model_program.apply_head
        if eff.shape[0] == 1:
            return head(params_for_row(0), eff)
        return torch.stack([head(params_for_row(i), eff[i : i + 1])[0] for i in range(eff.shape[0])])

    def _head_executable(self) -> Callable:
        """The head alone, held in the shared cache like every executable."""
        key = self._model_sig + ("head", str(self.device))
        head = self.model_program.apply_head
        return self._cache.get(key, lambda: self.backend.instrumented(head, site="head"))

    def _patch_executable(self) -> Callable:
        key = self._model_sig + ("head-patch", str(self.device))

        def build() -> Callable:
            def run(head_params, counts, prev_eff, window_keep):
                eff = _patch(self.device, counts, prev_eff, window_keep)
                return self._head_by_row(lambda i: head_params, eff), eff

            return self.backend.instrumented(run, site="head_patch")

        return self._cache.get(key, build)

    def _fused_patch_executable(self) -> Callable:
        key = self._model_sig + ("head-patch-fused", str(self.device))

        def build() -> Callable:
            def run(head_params_rows, counts, prev_eff, window_keep):
                eff = _patch(self.device, counts, prev_eff, window_keep)
                return self._head_by_row(lambda i: tree_map(lambda a: a[i], head_params_rows), eff), eff

            return self.backend.instrumented(run, site="head_patch_fused")

        return self._cache.get(key, build)

    # -- segments and streaming --------------------------------------------------
    def run_segment_weighted(
        self,
        kernel: torch.Tensor,
        bn_offset: torch.Tensor,
        frames: Any,
        *,
        head_params: Any | None = None,
        length: int | None = None,
        state: SegmentState | None = None,
        gate: Any = _USE_PROGRAM,
        m_bucket: int | None = None,
        early_exit: int | None = None,
        donate: bool | None = None,
    ) -> SegmentResult:
        """Model variant of :meth:`CompiledFrontend.run_segment_weighted`:
        each tick's skip-aware head pass runs inside the segment, carrying
        the previous effective map and logits on the device.
        ``result.logits`` is ``(K,) + head_out_shape`` (class logits, or raw
        per-cell maps that ``result.detections()`` splits)."""
        hp = self._require_head() if head_params is None else head_params
        seg = self._dispatch_segment(
            kernel, bn_offset, frames, length=length, state=state, gate=gate,
            m_bucket=m_bucket, early_exit=early_exit, donate=donate, head_params=hp,
        )
        self._m_runs.add(1)
        self._m_frames.add(seg.ticks)
        return seg

    def _stream_launch(self, frame: np.ndarray, window: np.ndarray | None, state: dict) -> dict:
        h_o, w_o = output_dims(self.spec)
        counts = self.run_frontend_weighted(
            self._require_weights(), self._bn, frame[None], None if window is None else window[None]
        )
        # the effective activation map lives in the iterator's state, never
        # on the handle: concurrent stream() iterators stay independent
        prev = state.get("eff")
        if prev is None:
            prev = torch.zeros((1, h_o, w_o, self.out_channels), device=self.device)
        keep = np.ones((1, h_o, w_o), bool) if window is None else window[None]
        logits, eff = self.patched_logits(counts, prev, keep)
        state["eff"] = eff
        return {"counts": counts, "logits": logits}

    def _stream_extra_results(self, entry: dict) -> dict:
        lg = _host(entry["logits"])[0]
        out: dict = {"logits": lg}
        dc = self.detect_classes
        if dc is not None:
            out["detections"] = Detections.from_raw(lg, dc)
        return out

    def _model_executable(self, m_bucket: int | None) -> Callable:
        if m_bucket is not None and not self.backend.bucket_sensitive:
            m_bucket = -1
        key = self._model_sig + (self.backend.name, "model", m_bucket, str(self.device))

        def build() -> Callable:
            return self.backend.instrumented(
                self.backend.make_model_executable(
                    self.model_program, self.model, m_bucket=m_bucket, device=self.device
                ),
                site="model",
            )

        return self._cache.get(key, build)


def compile(  # noqa: A001  (torch.compile-style public name)
    program: FPCAProgram | FPCAModelProgram | FPCASpec,
    *,
    backend: str | Backend | None = None,
    device: str | torch.device | None = None,
    mesh: Any | None = None,
    weights: Any | None = None,
    bn_offset: Any | None = None,
    head_params: Any | None = None,
    model: BucketCurvefitModel | None = None,
    cache: ExecutableCache | None = None,
    cache_capacity: int = 8,
    bucket_patience: int = 1,
    stats_parent: telemetry.StatsView | None = None,
) -> CompiledFrontend:
    """Compile a program into a held executable handle.

    Args:
      program: an :class:`FPCAProgram` (or a bare :class:`FPCASpec`), or an
        :class:`FPCAModelProgram`, which yields a :class:`CompiledModel`.
      backend: registered backend name or instance; default ``"cuda"`` on the
        card and ``"basis"`` on the host.
      device: where the handle runs; the CUDA card by default (raises when
        there is none — pass ``device="cpu"`` to run on the host).
      mesh: optional :class:`~torch.distributed.device_mesh.DeviceMesh` on
        ``device``'s type — batches shard over its data axes and batch
        padding rounds up to the data-axis extent (every rank calls the
        handle with the same batch and gets the whole result back).
      weights / bn_offset / head_params: program the weights immediately.
      model: fitted bucket model; fitted on ``device`` from
        ``program.circuit`` when omitted.
      cache: share one bounded :class:`ExecutableCache` across handles;
        a private cache of ``cache_capacity`` otherwise.
      bucket_patience: sticky-bucket hysteresis for region-skip row buckets
        (``1`` = stateless).
      stats_parent: optional :class:`repro_torch.fpca.telemetry.StatsView`
        whose same-named cells receive every increment of the handle's stats
        (how ``FPCAPipeline`` single-sources its fleet totals).
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
    with telemetry.span("compile", {"backend": be.name, "model": is_model}):
        if model is None:
            model = fit_bucket_model(frontend.circuit, n_pixels=frontend.spec.n_active_pixels, device=dev)
        common = dict(
            backend=be, model=model, device=dev, mesh=mesh, cache=cache,
            cache_capacity=cache_capacity, bucket_patience=bucket_patience,
            stats_parent=stats_parent,
        )
        handle: CompiledFrontend
        if is_model:
            handle = CompiledModel(program, head_params=head_params, **common)
        else:
            handle = CompiledFrontend(program, **common)
        if weights is not None:
            handle.reprogram(weights, bn_offset)
    return handle
