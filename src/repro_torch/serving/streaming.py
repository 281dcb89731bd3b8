"""Streaming video frontend: temporal delta-gated region skipping with an
asynchronous double-buffered serving loop.

The paper's extreme-edge scenario is a sensor watching a scene: §3.4.5's
region skipping pays off when the block keep masks are derived frame to
frame.  This module closes that loop:

* :class:`StreamSession` holds one stream's state (the previous effective
  frame, the per-block change ages, the configuration(s) it serves) and
  steps a temporal delta gate per frame: per-``skip_block`` change detection
  against the previous frame, with hysteresis (a changed block stays live
  for a few frames) and a periodic keyframe (a full readout every
  ``keyframe_interval`` frames).  The block mask becomes the per-window keep
  mask the kernel path compacts on, so skipped windows never execute.

* :class:`StreamServer` drives many cameras through the batch pipeline
  (:class:`repro_torch.serving.fpca_pipeline.FPCAPipeline`): every stream
  of one configuration group is gated (in one batched gate call) and fanned
  into ONE fused launch per tick, up to ``depth`` ticks stay in flight, and
  results are realised in frame order.  A stream may fan out to several
  configurations sharing one spec (one channel-stacked launch), each with
  its own gate and servo; model configurations get the skip-aware head.
  :meth:`StreamServer.run_segment` serves K ticks of one stream as one
  segment (one CUDA graph replay on the card).

The gate numerics are :mod:`repro_torch.core.gating`'s torch ops, evaluated
on the session's device: the segment executor runs the same functions on
the same device, so both decide on identical float32 bits.  Single-camera serving without a scheduler is
:meth:`repro_torch.fpca.CompiledFrontend.stream` and
:meth:`~repro_torch.fpca.CompiledFrontend.run_segment`.

Bit-exactness contract: kept-window activations are identical to a dense
readout; skipped windows read as exact zeros.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import analysis, gating, mapping
from repro_torch.device import resolve_device
from repro_torch.fpca import telemetry
from repro_torch.fpca.program import DeltaGateConfig, GateControllerConfig, ProgrammedModel
from repro_torch.models.heads import Detections
from repro_torch.serving.control import GateController
from repro_torch.serving.fpca_pipeline import FPCAPipeline
from repro_torch.training.tree import tree_map

__all__ = [
    "DeltaGateConfig",
    "GateController",
    "GateControllerConfig",
    "StreamSession",
    "StreamFrameResult",
    "StreamServer",
    "StreamStats",
    "block_delta",
    "block_delta_mask",
]


_USE_SERVER = object()   # add_stream sentinel: "inherit the server default"


def _host(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _block_reduce_mean(x: np.ndarray, block: int) -> np.ndarray:
    """Mean over ``block x block`` tiles of a host array (ragged edge tiles
    average their real pixels only), shape ``(ceil(h/b), ceil(w/b))``: the
    event polarity source, in the reference's numpy arithmetic."""
    h, w = x.shape
    bh, bw = math.ceil(h / block), math.ceil(w / block)
    padded = np.zeros((bh * block, bw * block), x.dtype)
    padded[:h, :w] = x
    sums = padded.reshape(bh, block, bw, block).sum((1, 3))
    ones = np.zeros((bh * block, bw * block), np.float32)
    ones[:h, :w] = 1.0
    counts = ones.reshape(bh, block, bw, block).sum((1, 3))
    return sums / counts


def _frame_arg(frame: Any) -> Any:
    """A frame for the gate kernels: a tensor stays where it is, anything
    else becomes a float32 host array."""
    return frame if isinstance(frame, torch.Tensor) else np.asarray(frame, np.float32)


def _effective_frame(
    frame: np.ndarray, spec: mapping.FPCASpec, device: str | torch.device | None = None
) -> np.ndarray:
    """Frame as the pixel array sees it: binned (average pool) grayscale,
    through :mod:`repro_torch.core.gating` on ``device`` (the card unless
    named)."""
    kernels = gating.host_gate_kernels(spec, resolve_device(device))
    return _host(kernels.eff(np.asarray(frame, np.float32)))


def block_delta(
    prev_eff: np.ndarray,
    cur_eff: np.ndarray,
    spec: mapping.FPCASpec,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Mean absolute per-block change between two effective (binned) frames,
    the statistic every threshold compares against; gating's numerics on
    ``device`` (the card unless named)."""
    kernels = gating.host_gate_kernels(spec, resolve_device(device))
    return _host(kernels.delta(np.asarray(prev_eff, np.float32), np.asarray(cur_eff, np.float32)))


def block_delta_mask(
    prev_eff: np.ndarray,
    cur_eff: np.ndarray,
    spec: mapping.FPCASpec,
    threshold: float,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Per-block change detection between two effective frames: the boolean
    ``(ceil(eff_h/B), ceil(eff_w/B))`` grid the periphery SRAM would hold
    (True = changed beyond ``threshold``), the shape
    :func:`repro_torch.core.mapping.active_window_mask` consumes."""
    return block_delta(prev_eff, cur_eff, spec, device) > threshold


class _GateState:
    """Delta-gate state for one configuration of one stream: its own gate
    knobs, block-age grid, servo controller and retained mask history."""

    def __init__(
        self,
        name: str,
        gate: DeltaGateConfig,
        controller: GateController | None,
        block_shape: tuple[int, int],
        history: int,
    ):
        self.name = name
        self.gate = gate
        self.controller = controller
        self.age = np.full(block_shape, gate.hysteresis + 1, np.int64)
        self.last_keyframe = False
        self.last_block_mask: np.ndarray | None = None
        self.last_window_mask: np.ndarray | None = None
        # the raw threshold comparison of the most recent gated tick (None
        # before the first delta) and its running count of changed blocks;
        # an EventTap's packets reconcile with it exactly
        # (repro_torch.serving.observe.assert_reconciled)
        self.last_changed: np.ndarray | None = None
        self.changed_total = 0
        # gate history for energy accounting, bounded so a long-running
        # stream does not leak (the report covers the retained window)
        self.block_masks: collections.deque[np.ndarray] = collections.deque(maxlen=history)

    def step(
        self,
        spec: mapping.FPCASpec,
        delta_blocks: np.ndarray | None,
        frame_idx: int,
    ) -> np.ndarray:
        """Advance this config's gate by one frame (``delta_blocks`` is the
        shared per-block |Δ| grid, ``None`` on the first frame)."""
        if delta_blocks is not None:
            # float32 threshold on both sides, the comparison the segment
            # body makes on the device
            changed = delta_blocks > np.float32(self.gate.threshold)
            self.age = np.where(changed, 0, self.age + 1)
            self.last_changed = changed
            self.changed_total += int(changed.sum())
        else:
            self.last_changed = None
        keyframe = delta_blocks is None or (
            self.gate.keyframe_interval > 0 and frame_idx % self.gate.keyframe_interval == 0
        )
        keep = np.ones_like(self.age, bool) if keyframe else self.age <= self.gate.hysteresis
        self.last_keyframe = keyframe
        self.last_block_mask = keep
        self.block_masks.append(keep)
        # the per-window keep grid, derived once per frame: the dispatch
        # reuses it and the keep-metric servo observes its mean
        window = mapping.active_window_mask(spec, keep)
        self.last_window_mask = window
        if self.controller is not None:
            obs = float(window.mean()) if self.controller.config.metric == "keep" else None
            new_thr = self.controller.observe(keep, keyframe=keyframe, observation=obs)
            if new_thr != self.gate.threshold:
                self.gate = dataclasses.replace(self.gate, threshold=new_thr)
        return keep


class StreamSession:
    """Per-stream state: previous frame, block ages, programmed config(s).

    ``config`` may be one configuration name or a sequence of names sharing
    one spec (fan-out); :attr:`configs` holds the normalised tuple and
    :attr:`config` the primary name.  ``gate`` is one
    :class:`DeltaGateConfig` shared by every configuration, or a mapping
    ``{config_name: DeltaGateConfig}`` giving each its own gate;
    ``controller`` follows the same shape with :class:`GateController`
    instances.  ``device`` is where the gate numerics run (the card unless
    ``device="cpu"``); it must be the device of the handle whose segments
    the session absorbs.
    """

    def __init__(
        self,
        stream_id: str,
        config: str | Sequence[str],
        spec: mapping.FPCASpec,
        gate: DeltaGateConfig | Mapping[str, DeltaGateConfig] | None,
        history: int = 512,
        controller: GateController | Mapping[str, GateController] | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.stream_id = stream_id
        self.configs: tuple[str, ...] = (config,) if isinstance(config, str) else tuple(config)
        if not self.configs:
            raise ValueError("need at least one config name")
        self.spec = spec
        self.device = resolve_device(device)
        self.per_config = isinstance(gate, Mapping) or isinstance(controller, Mapping)
        self.frame_idx = 0
        self._prev: torch.Tensor | None = None      # previous effective frame, on the device
        bh, bw = gating.block_grid(spec)
        self.last_window_mask: np.ndarray | None = None
        # per-config effective activation map (model configs only): the
        # running frontend output with each tick's kept windows patched in,
        # what the skip-aware head classifies
        self._eff: dict[str, Any] = {}
        # the carry threaded between segment launches (None until the stream
        # first serves a segment)
        self._segment_state: Any | None = None
        # set by an attached EventTap: step() then keeps the signed block
        # mean change (the gate only needs |Δ|) for the event polarity
        self.want_events = False
        self._last_signed: np.ndarray | None = None

        def _pick(mapping_or_one: Any, name: str, kind: str) -> Any:
            if isinstance(mapping_or_one, Mapping):
                try:
                    return mapping_or_one[name]
                except KeyError:
                    raise KeyError(
                        f"per-config {kind} mapping is missing config "
                        f"{name!r} of stream {stream_id!r}"
                    ) from None
            return mapping_or_one

        self._states: list[_GateState] = []
        self._by_name: dict[str, _GateState] = {}
        # gating-off sessions still expose a (never-appended) mask history
        self._fallback_masks: collections.deque[np.ndarray] = collections.deque(maxlen=history)
        if gate is None and not self.per_config:
            self.gating = False
            return
        self.gating = True
        if self.per_config:
            for name in self.configs:
                g = _pick(gate, name, "gate")
                if g is None:
                    raise ValueError(f"per-config gating needs a DeltaGateConfig for config {name!r}")
                st = _GateState(name, g, _pick(controller, name, "controller"), (bh, bw), history)
                self._states.append(st)
                self._by_name[name] = st
        else:
            st = _GateState(self.configs[0], gate, controller, (bh, bw), history)
            self._states.append(st)
            for name in self.configs:
                self._by_name[name] = st

    # -- the primary config's gate state ------------------------------------
    @property
    def config(self) -> str:
        """Primary configuration name (first of :attr:`configs`)."""
        return self.configs[0]

    @property
    def _primary(self) -> _GateState | None:
        return self._states[0] if self._states else None

    @property
    def gate(self) -> DeltaGateConfig | None:
        """Primary config's gate (None = gating off / dense)."""
        st = self._primary
        return st.gate if st is not None else None

    @property
    def controller(self) -> GateController | None:
        st = self._primary
        return st.controller if st is not None else None

    @property
    def last_keyframe(self) -> bool:
        st = self._primary
        return st.last_keyframe if st is not None else False

    @property
    def block_masks(self) -> collections.deque:
        st = self._primary
        return st.block_masks if st is not None else self._fallback_masks

    @property
    def prev_eff(self) -> np.ndarray | None:
        """The previous effective frame, on the host (None before a frame)."""
        return None if self._prev is None else _host(self._prev)

    def state_for(self, config: str) -> _GateState | None:
        """This config's gate state (shared state unless per-config)."""
        return self._by_name.get(config)

    def step(
        self,
        frame: np.ndarray,
        precomputed: tuple[Any, Any] | None = None,
    ) -> np.ndarray | None:
        """Advance one frame; returns the block keep mask (None = dense).

        A block is kept iff it changed within the last ``hysteresis + 1``
        frames; keyframes (the first frame, then every ``keyframe_interval``)
        keep everything but do not reset the ages.  With controllers
        attached, the masks feed the threshold servo(s), so the next frame
        gates with the servoed threshold(s).  With per-config gates the
        returned mask (and :attr:`last_window_mask`) is the union over
        configs; each config's own decision is on :meth:`state_for`.

        ``precomputed`` is this tick's ``(effective frame, block |Δ| grid)``
        when a caller computed it already in a batched gate call
        (:attr:`repro_torch.core.gating.HostGateKernels.step_batch`, bit for
        bit the solo numerics); the threshold comparisons and ages still run
        here.  ``frame`` may be a host array or a tensor on the session's
        device.
        """
        if not self.gating:
            self.frame_idx += 1
            return None
        kernels = gating.host_gate_kernels(self.spec, self.device)
        delta_t = None
        if precomputed is not None:
            cur = torch.as_tensor(precomputed[0], dtype=torch.float32, device=self.device)
            delta_t = precomputed[1]
        elif self._prev is None:
            cur = kernels.eff(_frame_arg(frame))
        else:
            # the effective frame and the block deltas in one call: the
            # gate result is needed at once to build this tick's window mask
            cur, delta_t = kernels.step(self._prev, _frame_arg(frame))
        delta_blocks = None if delta_t is None else np.asarray(_host(delta_t), np.float32)
        if self.want_events:
            # polarity source for the event tap: the signed block-mean
            # change, taken before ``_prev`` is overwritten below
            self._last_signed = (
                None
                if delta_blocks is None or self._prev is None
                else _block_reduce_mean(_host(cur) - _host(self._prev), self.spec.skip_block)
            )
        union_keep: np.ndarray | None = None
        union_window: np.ndarray | None = None
        for st in self._states:
            keep = st.step(self.spec, delta_blocks, self.frame_idx)
            union_keep = keep if union_keep is None else union_keep | keep
            window = st.last_window_mask
            union_window = window if union_window is None else union_window | window
        self._prev = cur
        self.frame_idx += 1
        self.last_window_mask = union_window
        return union_keep

    def absorb_segment(self, seg) -> None:
        """Fold one finished segment (:class:`repro_torch.fpca.SegmentResult`)
        into this session.

        A segment serves K ticks from one replay, so the session never saw
        those frames: its gate state (previous frame, block ages, frame
        index, mask history, servo) is rebuilt here from the segment's
        bookkeeping.  Per-tick :meth:`step` serving then continues bit for
        bit from where the segment stopped, and :meth:`energy_report` covers
        the segment's ticks.  The servo applies one bounded actuation at the
        boundary (:meth:`GateController.observe_segment`).
        """
        if self.per_config:
            raise NotImplementedError(
                "compiled segments serve one gate per stream; per-config "
                "fan-out streams must use per-tick serving"
            )
        ticks = seg.ticks
        if not seg.gated or not self.gating:
            if seg.gated != self.gating:
                raise ValueError(
                    "segment gating does not match this session "
                    f"(segment gated={seg.gated}, session gating={self.gating})"
                )
            self.frame_idx += ticks
            return
        st = self._primary
        masks = [np.asarray(m) for m in seg.block_masks[:ticks]]
        for m in masks:
            st.block_masks.append(m)
        if ticks:
            st.last_keyframe = bool(seg.keyframes[ticks - 1])
            st.last_block_mask = masks[-1]
            window = mapping.active_window_mask(self.spec, masks[-1])
            st.last_window_mask = window
            self.last_window_mask = window
        st.age = np.asarray(torch.as_tensor(seg.state.age).cpu(), np.int64)
        self._prev = torch.as_tensor(seg.state.prev_eff, dtype=torch.float32, device=self.device)
        self.frame_idx = int(seg.state.frame_idx)
        if st.controller is not None and ticks:
            obs = None
            if st.controller.config.metric == "keep":
                h_o, w_o = mapping.output_dims(self.spec)
                obs = [float(k) / float(h_o * w_o) for k in seg.kept_windows[:ticks]]
            new_thr = st.controller.observe_segment(
                masks, keyframes=seg.keyframes[:ticks], observations=obs
            )
            if new_thr != st.gate.threshold:
                st.gate = dataclasses.replace(st.gate, threshold=new_thr)

    def energy_report(
        self,
        const: analysis.FrontendConstants | None = None,
        config: str | None = None,
    ) -> dict:
        """Executed-window energy/cycle accounting over the retained gate
        history (the last ``history`` frames).  ``config`` selects one
        configuration's gate history (default: the primary's)."""
        if config is not None:
            st = self._by_name.get(config)
            if st is None:
                raise KeyError(f"unknown config {config!r} for this session")
            masks = st.block_masks
        else:
            masks = self.block_masks
        return analysis.streaming_frontend_report(
            self.spec, list(masks), const or analysis.FrontendConstants()
        )


@dataclasses.dataclass
class StreamFrameResult:
    """One (stream, config)'s activations for one tick.

    Streams on a model configuration also carry per-tick ``logits``: the
    skip-aware head patches this tick's kept-window activations into the
    previous effective activation map and runs the head on it, so a
    mostly-skipped tick still yields a decision (an all-skipped tick
    reproduces the previous logits exactly).
    """

    stream_id: str
    frame_idx: int
    counts: np.ndarray              # (h_o, w_o, c_o) SS-ADC counts
    block_mask: np.ndarray | None   # gate output (None = dense readout)
    kept_windows: int
    total_windows: int
    config: str = ""                # configuration these counts belong to
    logits: np.ndarray | None = None  # (n_classes,) logits, or the raw
    #                                 # (gh, gw, n_classes + 4) detection map
    detections: Any | None = None   # heads.Detections: detection configs
    events: Any | None = None       # events.EventPacket: event-tap streams

    @property
    def kept_fraction(self) -> float:
        return self.kept_windows / max(self.total_windows, 1)

    @property
    def predicted_class(self) -> int | None:
        """Argmax class of a classifier tick; None for counts-only ticks and
        for detection ticks (whose logits are per-cell maps)."""
        if self.logits is None or np.ndim(self.logits) != 1:
            return None
        return int(np.argmax(self.logits))


class StreamStats(telemetry.StatsView):
    """Fleet-level streaming counters, registry-backed (see
    :class:`repro_torch.fpca.telemetry.StatsView`).

    ``windows_kept`` counts logical kept windows (before bucket padding);
    ``launches_skipped`` counts all-skipped ticks (per-tick short-circuits
    and zero-kept ticks inside segments); ``bucket_switches`` /
    ``bucket_shrinks_deferred`` mirror the sticky bucket hysteresis;
    ``segments`` / ``segment_ticks`` cover segment launches;
    ``fused_head_calls`` counts shared-head fusion launches;
    ``serve_seconds`` accumulates wall-clock serving time.
    """

    _PREFIX = "fpca_stream"
    _FIELDS = (
        "ticks",
        "frames",
        "windows_total",
        "windows_kept",
        "launches_skipped",
        "bucket_switches",
        "bucket_shrinks_deferred",
        "segments",
        "segment_ticks",
        "fused_head_calls",
        "serve_seconds",
    )


class StreamServer:
    """Asynchronous double-buffered multi-stream driver over
    :class:`FPCAPipeline`.

    A thin fleet-orchestration layer: gating and batching happen here, every
    fused launch goes through the pipeline's per-signature handles (a single
    camera can skip this class and use
    :meth:`repro_torch.fpca.CompiledFrontend.stream`).

    Args:
      pipeline: the serving pipeline whose registered configurations,
        executable cache and device this server reuses.
      gate: delta-gate configuration applied to every stream; pass
        ``gating=False`` for a dense baseline server.  With a ``controller``
        this is only the initial gate: each stream's threshold is then
        servoed on its own.  Both can be overridden per stream (and per
        config) in :meth:`add_stream`.
      controller: optional :class:`GateControllerConfig`; every stream added
        afterwards gets its own :class:`GateController`.
      depth: maximum in-flight ticks.  ``2`` is double buffering: while the
        card runs tick ``t``, the host gates and batches tick ``t+1``;
        results for ``t`` are realised when ``t+2`` is about to dispatch.
      fuse_shared_heads: model configs of one launch binding the same model
        signature run one head pass over all their (config, stream) rows.
    """

    def __init__(
        self,
        pipeline: FPCAPipeline,
        gate: DeltaGateConfig = DeltaGateConfig(),
        *,
        depth: int = 2,
        gating: bool = True,
        controller: GateControllerConfig | None = None,
        fuse_shared_heads: bool = True,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipeline = pipeline
        self.gate = gate if gating else None
        self.controller = controller if gating else None
        self.depth = depth
        self.fuse_shared_heads = fuse_shared_heads
        self.sessions: dict[str, StreamSession] = {}
        self.event_taps: dict[str, Any] = {}
        self.stats = StreamStats()
        # prebuilt span label dicts, so an enabled-telemetry tick allocates
        # no dicts on the hot loop
        self._span_fields = {"server": self.stats._labels["instance"]}
        self._seg_fields: dict[str, dict] = {}

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def add_stream(
        self,
        stream_id: str,
        config: str | Sequence[str],
        *,
        gate: Any = _USE_SERVER,
        controller: Any = _USE_SERVER,
        events: bool = False,
    ) -> StreamSession:
        """Attach a camera stream to registered pipeline configuration(s).

        ``events=True`` attaches an :class:`repro_torch.serving.events.EventTap`:
        every served tick also emits the gate's changed blocks as an
        address-event packet on ``StreamFrameResult.events`` (a gated,
        shared-gate stream only).

        A sequence of names fans the stream out to several configurations
        sharing one spec and compile signature: each tick is gated and served
        through one channel-stacked launch, yielding one
        :class:`StreamFrameResult` per configuration.

        ``gate`` / ``controller`` override the server defaults for this
        stream: a config replaces the default, an explicit ``None`` disables
        gating / servoing, omitting the argument inherits.  A mapping
        ``{config_name: DeltaGateConfig}`` (and / or ``{config_name:
        GateControllerConfig}``) gives each configuration its own gate and
        servo: the launch executes the union of the per-config masks and
        each config's results are masked back to its own keep decision.
        """
        if stream_id in self.sessions:
            raise ValueError(f"stream {stream_id!r} already attached")
        names = (config,) if isinstance(config, str) else tuple(config)
        cfgs = []
        for n in names:
            cfg = self.pipeline._configs.get(n)
            if cfg is None:
                raise KeyError(f"unknown config {n!r}")
            cfgs.append(cfg)
        spec = cfgs[0].spec
        base = cfgs[0].program.fanout_signature()
        for cfg in cfgs[1:]:
            # one stacked launch per tick serves one adc/enc/circuit epilogue
            if cfg.program.fanout_signature() != base:
                raise ValueError(
                    f"multi-config stream needs a shared spec and compile "
                    f"signature (adc/enc/circuit): config {cfg.name!r} "
                    f"differs from {cfgs[0].name!r}"
                )
        eff_gate = self.gate if gate is _USE_SERVER else gate
        eff_ctl = self.controller if controller is _USE_SERVER else controller
        per_config = isinstance(eff_gate, Mapping) or isinstance(eff_ctl, Mapping)

        def _controller_for(g: DeltaGateConfig, name: str) -> GateController | None:
            if eff_ctl is None or g is None:
                return None
            conf = eff_ctl[name] if isinstance(eff_ctl, Mapping) else eff_ctl
            if not conf:
                return None
            return GateController(conf, spec, g.threshold, name=f"{stream_id}/{name}")

        dev = self.device
        if per_config:
            if eff_gate is None:
                raise ValueError("per-config controllers need gating enabled (pass gate=)")
            for kind, m in (("gate", eff_gate), ("controller", eff_ctl)):
                if isinstance(m, Mapping):
                    missing = [n for n in names if n not in m]
                    if missing:
                        raise KeyError(
                            f"per-config {kind} mapping is missing config "
                            f"{missing[0]!r} of stream {stream_id!r}"
                        )
            gate_map = {n: (eff_gate[n] if isinstance(eff_gate, Mapping) else eff_gate) for n in names}
            ctl_map = {n: _controller_for(gate_map[n], n) for n in names}
            session = StreamSession(stream_id, names, spec, gate_map, controller=ctl_map, device=dev)
        else:
            ctl = _controller_for(eff_gate, names[0]) if eff_gate is not None else None
            session = StreamSession(stream_id, names, spec, eff_gate, controller=ctl, device=dev)
        self.sessions[stream_id] = session
        self._seg_fields[stream_id] = {"stream": stream_id}
        if events:
            from repro_torch.serving.events import EventTap

            try:
                self.event_taps[stream_id] = EventTap(session)
            except Exception:
                # leave no half-attached stream behind
                del self.sessions[stream_id]
                del self._seg_fields[stream_id]
                raise
        return session

    # -- serving loop --------------------------------------------------------
    def _dispatch(self, frames: Mapping[str, Any]) -> list[dict]:
        """Host side of one tick: gate every stream, fan streams into one
        batch per configuration group, dispatch without waiting."""
        per_group: dict[tuple[str, ...], list[tuple[StreamSession, Any]]] = {}
        for stream_id, frame in frames.items():
            session = self.sessions.get(stream_id)
            if session is None:
                raise KeyError(f"unknown stream {stream_id!r}")
            per_group.setdefault(session.configs, []).append((session, frame))
        pstats = self.pipeline.stats
        before = (pstats.bucket_switches, pstats.bucket_shrinks_deferred, pstats.launches_skipped)
        dev = self.device
        launches: list[dict] = []
        for configs, members in per_group.items():
            spec = members[0][0].spec
            h_o, w_o = mapping.output_dims(spec)
            entries = []
            keeps = []
            gated = any(session.gating for session, _ in members)
            # the group's frames go to the device once: the gate reads them
            # and the launch reuses them
            raw = [f for _, f in members]
            if any(isinstance(f, torch.Tensor) for f in raw):
                images = torch.stack([torch.as_tensor(f, dtype=torch.float32, device=dev) for f in raw])
            else:
                images = torch.as_tensor(np.stack([np.asarray(f, np.float32) for f in raw]), device=dev)
            # fleet-batched gating: every warmed-up gated stream of the
            # group computes its effective frame and block |Δ| grid in ONE
            # call (bit for bit the solo numerics) and one read-back;
            # first-frame and dense streams take the per-stream path
            pre: dict[int, tuple[Any, np.ndarray]] = {}
            rows = [i for i, (s, _) in enumerate(members) if s.gating and s._prev is not None]
            if len(rows) > 1:
                kern = gating.host_gate_kernels(spec, dev)
                curs, deltas = kern.step_batch(
                    torch.stack([members[i][0]._prev for i in rows]),
                    images[rows] if len(rows) < len(members) else images,
                )
                deltas = _host(deltas)
                pre = {i: (curs[j], deltas[j]) for j, i in enumerate(rows)}
            for row, (session, _) in enumerate(members):
                frame_idx = session.frame_idx
                block = session.step(images[row], precomputed=pre.get(row))
                window = session.last_window_mask if session.gating else None
                kept = int(window.sum()) if window is not None else h_o * w_o
                entry = {
                    "stream_id": session.stream_id,
                    "frame_idx": frame_idx,
                    "block_mask": block,
                    "kept": kept,
                    "total": h_o * w_o,
                }
                if session.per_config:
                    entry["per_config"] = {
                        st.name: (st.last_block_mask, int(st.last_window_mask.sum()), st.last_window_mask)
                        for st in session._states
                    }
                tap = self.event_taps.get(session.stream_id)
                if tap is not None:
                    # this tick's address-event packet, from the gate state
                    # step() just wrote (the changed array the gate counted)
                    entry["events"] = tap.observe_tick(frame_idx)
                entries.append(entry)
                if gated:
                    keeps.append(window if window is not None else np.ones((h_o, w_o), bool))
                self.stats.frames += 1
                self.stats.windows_total += h_o * w_o
                self.stats.windows_kept += kept
            counts = self.pipeline.run_config_batch(
                configs[0] if len(configs) == 1 else list(configs),
                images,
                np.stack(keeps) if gated else None,
            )
            slices = (
                self.pipeline.config_channel_slices(configs)
                if len(configs) > 1
                else [(configs[0], None, None)]
            )
            launch = {"counts": counts, "entries": entries, "slices": slices}
            self._model_head_pass(launch, members, h_o, w_o)
            launches.append(launch)
        self.stats.bucket_switches += pstats.bucket_switches - before[0]
        self.stats.bucket_shrinks_deferred += pstats.bucket_shrinks_deferred - before[1]
        self.stats.launches_skipped += pstats.launches_skipped - before[2]
        return launches

    def _model_head_pass(self, launch: dict, members: list, h_o: int, w_o: int) -> None:
        """Skip-aware digital head for the model configurations of one group.

        For every :class:`repro_torch.fpca.ProgrammedModel` slice of the
        launch: patch each member stream's kept windows into its previous
        effective activation map (per-config masks when the stream gates per
        config) and run the head on the patched maps, without waiting on the
        device.  An all-skipped tick reproduces the previous logits exactly.
        Each row's head runs at batch 1
        (:meth:`repro_torch.fpca.CompiledModel.patched_logits`), so a row's
        logits equal that camera's solo ``stream()`` bit for bit.

        Shared-head fusion (``fuse_shared_heads``): model configs of one
        launch binding the same model signature collapse into ONE
        :meth:`~repro_torch.fpca.CompiledModel.fused_patched_logits` pass
        over all stacked (config, stream) rows, each row binding its own
        config's head parameters; bit for bit the per-config results.
        """
        counts = launch["counts"]
        logits_by_config: dict[str, Any] = {}
        detect_by_config: dict[str, int] = {}
        model_slices: list[tuple] = []
        for name, lo, hi in launch["slices"]:
            cfg = self.pipeline._configs[name]
            if not isinstance(cfg, ProgrammedModel):
                continue
            model_slices.append((name, lo, hi, cfg))
            dc = cfg.model.detect_classes
            if dc is not None:
                detect_by_config[name] = dc
        if not model_slices:
            return
        dev = self.device

        def gather(name, lo, hi, cfg):
            sliced = counts if lo is None else counts[..., lo:hi]
            prevs, keeps = [], []
            for session, _ in members:
                prev = session._eff.get(name)
                if prev is None:
                    prev = torch.zeros((h_o, w_o, cfg.out_channels), device=dev)
                prevs.append(prev)
                st = session.state_for(name)
                if session.gating and st is not None and st.last_window_mask is not None:
                    keeps.append(st.last_window_mask)
                else:
                    keeps.append(np.ones((h_o, w_o), bool))
            return sliced, prevs, keeps

        groups: dict[tuple, list[tuple]] = {}
        for item in model_slices:
            groups.setdefault(item[3].model.signature(), []).append(item)
        n = len(members)
        for group in groups.values():
            handle = self.pipeline.model_handle_for(group[0][3].model)
            if len(group) == 1 or not self.fuse_shared_heads:
                for name, lo, hi, cfg in group:
                    sliced, prevs, keeps = gather(name, lo, hi, cfg)
                    logits, eff = handle.patched_logits(
                        sliced, torch.stack(prevs), np.stack(keeps), head_params=cfg.head_params
                    )
                    for row, (session, _) in enumerate(members):
                        session._eff[name] = eff[row]
                    logits_by_config[name] = logits
            else:
                # config-major row stacking: rows [g*n, (g+1)*n) are group
                # member g's streams, each row binding g's head parameters
                rows_c, rows_p, rows_k, hp_rows = [], [], [], []
                for name, lo, hi, cfg in group:
                    sliced, prevs, keeps = gather(name, lo, hi, cfg)
                    rows_c.append(sliced)
                    rows_p.extend(prevs)
                    rows_k.extend(keeps)
                    hp_rows.extend([cfg.head_params] * n)
                hp_stack = tree_map(lambda *xs: torch.stack(xs), *hp_rows)
                logits, eff = handle.fused_patched_logits(
                    hp_stack, torch.cat(rows_c, dim=0), torch.stack(rows_p), np.stack(rows_k)
                )
                self.stats.fused_head_calls += 1
                for g, (name, lo, hi, cfg) in enumerate(group):
                    base = g * n
                    for row, (session, _) in enumerate(members):
                        session._eff[name] = eff[base + row]
                    logits_by_config[name] = logits[base:base + n]
        if logits_by_config:
            launch["logits"] = logits_by_config
        if detect_by_config:
            launch["detect"] = detect_by_config

    def _finalize(self, launches: list[dict]) -> list[StreamFrameResult]:
        """Device side of one tick: realise the batch (waits) and unpack.

        Per-config-gated streams executed the union mask; each config's
        channel slice is masked back to exactly its own keep decision (kept
        windows equal solo serving, row-independent math; windows the config
        skipped read as exact zeros)."""
        results: list[StreamFrameResult] = []
        for launch in launches:
            counts = _host(launch["counts"])     # waits for the launch
            logits_np = {name: _host(lg) for name, lg in launch.get("logits", {}).items()}
            detect = launch.get("detect", {})
            for row, e in enumerate(launch["entries"]):
                per_config = e.get("per_config")
                for idx, (name, lo, hi) in enumerate(launch["slices"]):
                    sliced = counts[row] if lo is None else counts[row, ..., lo:hi]
                    block, kept = e["block_mask"], e["kept"]
                    if per_config is not None and name in per_config:
                        block, kept, window = per_config[name]
                        sliced = sliced * window[..., None].astype(sliced.dtype)
                    lg = logits_np.get(name)
                    det = None
                    if lg is not None and name in detect:
                        det = Detections.from_raw(lg[row], detect[name])
                    results.append(
                        StreamFrameResult(
                            stream_id=e["stream_id"],
                            frame_idx=e["frame_idx"],
                            counts=sliced,
                            block_mask=block,
                            kept_windows=kept,
                            total_windows=e["total"],
                            config=name,
                            logits=None if lg is None else lg[row],
                            detections=det,
                            # one packet per (stream, tick): on the first
                            # fanned-out config's result only
                            events=e.get("events") if idx == 0 else None,
                        )
                    )
        return results

    def run(self, ticks: Iterable[Mapping[str, Any]]) -> Iterator[list[StreamFrameResult]]:
        """Serve a stream of ticks; yields one result list per tick, in order.

        Each tick maps ``stream_id -> frame``.  Up to ``depth`` ticks are in
        flight: dispatch does not wait on the card, so tick ``t``'s device
        work overlaps tick ``t+1``'s host gating and batching; results are
        realised oldest first, in frame order per stream.
        """
        inflight: collections.deque[list[dict]] = collections.deque()
        for frames in ticks:
            # the dispatch half of the tick is billed once, even when the
            # gate or batch path raises
            t0 = time.perf_counter()
            try:
                with telemetry.span("serve_tick", self._span_fields):
                    inflight.append(self._dispatch(frames))
                self.stats.ticks += 1
            finally:
                self.stats.serve_seconds += time.perf_counter() - t0
            while len(inflight) > self.depth:
                yield self._finalize_timed(inflight.popleft())
        while inflight:
            yield self._finalize_timed(inflight.popleft())

    def _finalize_timed(self, launches: list[dict]) -> list[StreamFrameResult]:
        """Realise one in-flight tick, billing its wall time once."""
        t0 = time.perf_counter()
        try:
            return self._finalize(launches)
        finally:
            self.stats.serve_seconds += time.perf_counter() - t0

    def serve(self, stream_id: str, frames: Iterable[Any]) -> Iterator[StreamFrameResult]:
        """Single-stream convenience wrapper around :meth:`run`: one result
        per tick, or a fan-out stream's per-config results back to back."""
        for results in self.run({stream_id: f} for f in frames):
            yield from results

    # -- segment mode --------------------------------------------------------
    def run_segment(
        self,
        stream_id: str,
        frames: Any,
        *,
        m_bucket: int | None = None,
        early_exit: int | None = None,
    ) -> list[StreamFrameResult]:
        """Serve a ``(K, H, W, c_i)`` frame stack of one stream as ONE
        segment (:meth:`repro_torch.fpca.CompiledFrontend.run_segment`: one
        CUDA graph replay on the card).

        The session's gate runs inside the segment (the same decisions; the
        session is rebuilt from the segment's bookkeeping by
        :meth:`StreamSession.absorb_segment`, so per-tick :meth:`run` and
        segments interleave freely on one stream).  The threshold servo
        takes one bounded step at the boundary.  Returns the per-tick
        results in frame order (fewer than K with ``early_exit``: feed the
        unserved tail to the next call).  Single-config streams only.
        """
        t0 = time.perf_counter()
        try:
            with telemetry.span("serve_segment", self._seg_fields.get(stream_id)):
                return self._run_segment_inner(stream_id, frames, m_bucket=m_bucket, early_exit=early_exit)
        finally:
            self.stats.serve_seconds += time.perf_counter() - t0

    def _run_segment_inner(
        self,
        stream_id: str,
        frames: Any,
        *,
        m_bucket: int | None = None,
        early_exit: int | None = None,
    ) -> list[StreamFrameResult]:
        session = self.sessions.get(stream_id)
        if session is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        if session.per_config or len(session.configs) > 1:
            raise NotImplementedError(
                "segment mode serves single-config streams; multi-config "
                "fan-out must use per-tick run()"
            )
        name = session.config
        state = session._segment_state
        if state is not None and int(state.frame_idx) != session.frame_idx:
            # per-tick serving advanced the stream since the last segment:
            # rebuild the carry from the session
            state = None
        if state is None and session.frame_idx > 0:
            state = self._state_from_session(session, name)
        start_idx = session.frame_idx
        tap = self.event_taps.get(stream_id)
        # event inputs, captured before the launch: the effective frame
        # carried into the segment and the threshold it gates with (the servo
        # actuates only at the boundary, inside absorb_segment)
        if tap is not None:
            prev_eff_in = (
                _host(state.prev_eff).astype(np.float32)
                if state is not None and bool(state.has_prev)
                else None
            )
            thr_in = float(session.gate.threshold)
        pstats = self.pipeline.stats
        before = (pstats.launches_skipped, pstats.segments, pstats.segment_ticks)
        seg = self.pipeline.run_config_segment(
            name,
            frames,
            state=state,
            gate=session.gate if session.gating else None,
            m_bucket=m_bucket,
            early_exit=early_exit,
        )
        session._segment_state = seg.state
        cfg = self.pipeline._configs[name]
        is_model = isinstance(cfg, ProgrammedModel)
        if is_model:
            session._eff[name] = seg.state.eff
        session.absorb_segment(seg)
        self.stats.launches_skipped += pstats.launches_skipped - before[0]
        self.stats.segments += pstats.segments - before[1]
        self.stats.segment_ticks += pstats.segment_ticks - before[2]
        ticks = seg.ticks
        h_o, w_o = mapping.output_dims(session.spec)
        total = h_o * w_o
        self.stats.ticks += ticks
        self.stats.frames += ticks
        self.stats.windows_total += ticks * total
        self.stats.windows_kept += int(seg.kept_windows[:ticks].sum())
        counts = _host(seg.counts)        # waits for the segment
        logits = None if seg.logits is None else _host(seg.logits)
        packets = None
        if tap is not None:
            # the segment keeps no per-tick gate internals on the host: the
            # served ticks' packets are re-derived through the same gating
            # functions on the same device, and folded into the tap and the
            # gate accounting together
            from repro_torch.serving.events import segment_events

            packets = segment_events(
                session.spec, _host(frames).astype(np.float32)[:ticks], prev_eff_in, thr_in,
                stream_id, start_idx, device=session.device,
            )
            tap.absorb_packets(packets)
        detect_classes = cfg.model.detect_classes if is_model else None
        results = []
        for t in range(ticks):
            lg = None if logits is None else logits[t]
            results.append(
                StreamFrameResult(
                    stream_id=stream_id,
                    frame_idx=start_idx + t,
                    counts=counts[t],
                    block_mask=np.asarray(seg.block_masks[t]) if seg.gated else None,
                    kept_windows=int(seg.kept_windows[t]),
                    total_windows=total,
                    config=name,
                    logits=lg,
                    detections=(
                        Detections.from_raw(lg, detect_classes)
                        if lg is not None and detect_classes is not None
                        else None
                    ),
                    events=None if packets is None else packets[t],
                )
            )
        return results

    def _state_from_session(self, session: StreamSession, name: str):
        """Segment carry seeded from the per-tick session, so a stream that
        served ticks through :meth:`run` continues in segment mode."""
        from repro_torch.fpca.executable import SegmentState

        spec = session.spec
        dev = session.device
        prev = session._prev
        st = session._primary
        bh, bw = gating.block_grid(spec)
        hyst = session.gate.hysteresis if session.gate is not None else 0
        state = SegmentState(
            has_prev=prev is not None,
            prev_eff=prev if prev is not None else torch.zeros((spec.eff_h, spec.eff_w), device=dev),
            age=st.age if st is not None else np.full((bh, bw), hyst + 1, np.int64),
            frame_idx=session.frame_idx,
        )
        cfg = self.pipeline._configs[name]
        if isinstance(cfg, ProgrammedModel):
            h_o, w_o = mapping.output_dims(spec)
            eff = session._eff.get(name)
            if eff is None:
                eff = torch.zeros((h_o, w_o, cfg.out_channels), device=dev)
            state.eff = eff
            # the segment's quiet-tick branch replays the carried logits; the
            # per-tick path recomputes head(eff), the same bits at batch 1
            handle = self.pipeline.model_handle_for(cfg.model)
            state.logits = handle.head_logits(eff[None], head_params=cfg.head_params)[0]
        return state

    def serve_segments(
        self,
        stream_id: str,
        frames: Iterable[Any],
        *,
        segment_length: int = 16,
        m_bucket: int | None = None,
        early_exit: int | None = None,
        on_segment: Any = None,
    ) -> Iterator[StreamFrameResult]:
        """Segment-mode twin of :meth:`serve`: buffers the frames into
        ``segment_length`` chunks and serves each as one segment, yielding
        per-tick results in frame order.  With ``early_exit`` a segment may
        serve fewer ticks; the unserved tail is carried into the next chunk.
        ``on_segment`` (a callable of the segment's result list) fires at
        every boundary, after the servo's boundary step: where
        :class:`repro_torch.serving.fleet.FleetController` re-solves the
        fleet budget split."""
        if segment_length < 1:
            raise ValueError("segment_length must be >= 1")
        buf: list[np.ndarray] = []
        for f in frames:
            buf.append(np.asarray(_host(f), np.float32))
            if len(buf) >= segment_length:
                results = self.run_segment(
                    stream_id, np.stack(buf[:segment_length]), m_bucket=m_bucket, early_exit=early_exit
                )
                if on_segment is not None:
                    on_segment(results)
                yield from results
                buf = buf[len(results):]
        while buf:
            results = self.run_segment(stream_id, np.stack(buf), m_bucket=m_bucket, early_exit=early_exit)
            if on_segment is not None:
                on_segment(results)
            yield from results
            buf = buf[len(results):]
