"""Streaming video frontend: the temporal delta gate of one stream.

The paper's extreme-edge scenario is a sensor watching a scene: §3.4.5's
region skipping pays off when the block keep masks are derived frame to
frame.  :class:`StreamSession` holds one stream's state (the previous
effective frame, the per-block change ages, the configuration(s) it serves)
and steps a temporal delta gate per frame: per-``skip_block`` change
detection against the previous frame, with hysteresis (a changed block
stays live for a few frames) and a periodic keyframe (a full readout every
``keyframe_interval`` frames).  The block mask becomes the per-window keep
mask that the kernel path compacts on, so skipped windows never execute.

The gate numerics are :mod:`repro_torch.core.gating`'s torch ops, evaluated
on the session's device: the segment executor on a handle runs the same
functions on the same device, so both decide on identical float32 bits.

This is the session half of the reference's ``serving/streaming.py``;
single-camera serving is :meth:`repro_torch.fpca.CompiledFrontend.stream`
and :meth:`~repro_torch.fpca.CompiledFrontend.run_segment`.  The
multi-stream ``StreamServer`` is built on the batch pipeline
(``serving/fpca_pipeline.py``), which the port does not have yet, and the
event taps (``serving/events.py``) on the server; both follow it.

Bit-exactness contract: kept-window activations are identical to a dense
readout; skipped windows read as exact zeros.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import analysis, gating, mapping
from repro_torch.device import resolve_device
from repro_torch.fpca import telemetry
from repro_torch.fpca.program import DeltaGateConfig, GateControllerConfig
from repro_torch.serving.control import GateController

__all__ = [
    "DeltaGateConfig",
    "GateController",
    "GateControllerConfig",
    "StreamSession",
    "StreamFrameResult",
    "StreamStats",
    "block_delta",
    "block_delta_mask",
]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


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
        # before the first delta) and its running count of changed blocks
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
        here.
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
            cur = kernels.eff(np.asarray(frame, np.float32))
        else:
            # the effective frame and the block deltas in one call: the gate
            # result is needed at once to build this tick's window mask
            cur, delta_t = kernels.step(self._prev, np.asarray(frame, np.float32))
        delta_blocks = None if delta_t is None else np.asarray(
            _host(delta_t) if isinstance(delta_t, torch.Tensor) else delta_t, np.float32
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
    events: Any | None = None       # event packets (the reference's event taps)

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
