"""Neuromorphic event streams: the delta gate's per-block changes as a
sensor output.

The temporal delta gate (:mod:`repro_torch.serving.streaming`) computes,
every tick, which blocks of the effective frame changed beyond a threshold:
the statistic an event camera emits as address-event spikes.
:class:`EventTap` surfaces it as a per-tick :class:`EventPacket` stream
(block coordinates, polarity = sign of the mean block change, a wall-clock
timestamp) with its own registry-backed :class:`EventStats` (labelled
``arch="events"``, so ``fleet_report()``'s workload table breaks the event
lane out next to classifier and detection traffic).

Two emission paths, one numerics contract:

* per tick: :meth:`EventTap.observe_tick` reads the gate state the session
  just stepped (the same ``changed`` array the gate counted, and the signed
  block-mean change taken before the previous frame was overwritten), so
  the tap's event counts equal the gate's changed-block count
  (:func:`repro_torch.serving.observe.assert_reconciled`);
* segment: a segment keeps no per-tick gate internals on the host, so
  :func:`segment_events` re-derives them from the frames and the carried
  previous effective frame through :mod:`repro_torch.core.gating` on the
  session's device, the functions the segment body runs there: the same
  decisions.

Attach a tap with ``StreamServer.add_stream(..., events=True)`` (or through
``FleetController.add_stream``); packets ride on
``StreamFrameResult.events``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import gating, mapping
from repro_torch.device import resolve_device
from repro_torch.fpca import telemetry
from repro_torch.serving.streaming import _block_reduce_mean, _host

__all__ = ["EventPacket", "EventStats", "EventTap", "segment_events"]


class EventStats(telemetry.StatsView):
    """Per-tap event accounting, registry-backed (labels carry
    ``arch="events"`` and the stream id).

    * ``ticks``      — gate ticks observed (packets emitted, empty ones too)
    * ``packets``    — packets emitted
    * ``events``     — changed blocks across all packets
    * ``events_pos`` / ``events_neg`` — polarity split; their sum is
      ``events`` exactly
    """

    _PREFIX = "fpca_events"
    _FIELDS = ("ticks", "packets", "events", "events_pos", "events_neg")


@dataclasses.dataclass(frozen=True)
class EventPacket:
    """One tick's address-events for one stream.

    ``coords`` are ``(row, col)`` on the ``grid_shape`` block grid
    (``block`` effective pixels a side); ``polarity`` is the sign of the
    mean block change (+1 brighter, -1 darker).  ``timestamp`` is the host
    emission wall clock (for a segment: when the packet was rebuilt).  A
    tick whose delta crossed no threshold, or a stream's first frame, emits
    an empty packet: packets stay aligned with the serving loop's ticks.
    """

    stream_id: str
    frame_idx: int
    coords: np.ndarray               # (n, 2) int32 block (row, col)
    polarity: np.ndarray             # (n,) int8 in {+1, -1}
    timestamp: float
    grid_shape: tuple[int, int]
    block: int

    @property
    def n_events(self) -> int:
        return int(self.coords.shape[0])

    def raster(self) -> np.ndarray:
        """Signed event grid: +1 / -1 at event blocks, 0 elsewhere."""
        grid = np.zeros(self.grid_shape, np.int8)
        if self.n_events:
            grid[self.coords[:, 0], self.coords[:, 1]] = self.polarity
        return grid


def _packet(
    stream_id: str,
    frame_idx: int,
    changed: np.ndarray | None,
    signed: np.ndarray | None,
    grid_shape: tuple[int, int],
    block: int,
) -> EventPacket:
    if changed is None or not changed.any():
        coords = np.zeros((0, 2), np.int32)
        polarity = np.zeros((0,), np.int8)
    else:
        ys, xs = np.nonzero(changed)
        coords = np.stack([ys, xs], axis=-1).astype(np.int32)
        polarity = np.where(signed[ys, xs] >= 0, 1, -1).astype(np.int8)
    return EventPacket(
        stream_id=stream_id,
        frame_idx=int(frame_idx),
        coords=coords,
        polarity=polarity,
        timestamp=time.time(),
        grid_shape=grid_shape,
        block=block,
    )


class EventTap:
    """Per-stream event emitter over a :class:`StreamSession`'s delta gate.

    Needs a gated, shared-gate session (per-config gates would give
    ambiguous per-block decisions).  ``packets`` keeps the last ``history``
    packets; :attr:`stats` is the registry-backed accounting.
    """

    def __init__(self, session: Any, history: int = 512):
        if session.per_config:
            raise NotImplementedError(
                "event streams need one shared gate per stream; per-config "
                "fan-out gates are unsupported"
            )
        if not session.gating:
            raise ValueError(
                f"event stream needs a gated stream; stream "
                f"{session.stream_id!r} is dense"
            )
        self.session = session
        session.want_events = True     # the session keeps the signed delta
        spec = session.spec
        self.grid_shape = gating.block_grid(spec)
        self.block = int(spec.skip_block)
        self.stats = EventStats(labels={"arch": "events", "stream": session.stream_id})
        self.packets: collections.deque[EventPacket] = collections.deque(maxlen=history)

    def observe_tick(self, frame_idx: int) -> EventPacket:
        """Emit this tick's packet from the gate state the session just
        stepped (the ``changed`` array its ``changed_total`` counted)."""
        st = self.session._primary
        packet = _packet(
            self.session.stream_id, frame_idx, st.last_changed, self.session._last_signed,
            self.grid_shape, self.block,
        )
        self._record(packet)
        return packet

    def absorb_packets(self, packets: list[EventPacket]) -> None:
        """Fold segment-rebuilt packets (:func:`segment_events`) into the
        tap and into the gate's changed-block count together: the segment's
        gate never touched the session's gate state."""
        st = self.session._primary
        for p in packets:
            self._record(p)
            st.changed_total += p.n_events

    def _record(self, packet: EventPacket) -> None:
        self.stats.ticks += 1
        self.stats.packets += 1
        n = packet.n_events
        if n:
            pos = int((packet.polarity > 0).sum())
            self.stats.events += n
            self.stats.events_pos += pos
            self.stats.events_neg += n - pos
        self.packets.append(packet)


def segment_events(
    spec: mapping.FPCASpec,
    frames: Any,
    prev_eff: Any | None,
    threshold: float,
    stream_id: str,
    first_frame_idx: int,
    *,
    device: str | torch.device | None = None,
) -> list[EventPacket]:
    """Re-derive per-tick event packets for a segment.

    ``frames`` are the segment's served ticks ``(ticks, H, W, c_i)``;
    ``prev_eff`` the effective frame carried into the segment (``None`` at
    stream start); ``threshold`` the gate threshold the segment ran with
    (taken before the boundary servo step).  The effective frames and block
    deltas come from :mod:`repro_torch.core.gating` on ``device`` (the card
    unless named; the device the segment ran on), so the changed-block
    decisions are the segment's own.
    """
    dev = resolve_device(device)
    kernels = gating.host_gate_kernels(spec, dev)
    grid_shape = gating.block_grid(spec)
    block = int(spec.skip_block)
    thr = np.float32(threshold)
    packets: list[EventPacket] = []
    prev = None if prev_eff is None else torch.as_tensor(np.asarray(prev_eff, np.float32), device=dev)
    for t, frame in enumerate(np.asarray(frames, np.float32)):
        cur = kernels.eff(frame)
        if prev is None:
            changed = signed = None
        else:
            changed = _host(kernels.delta(prev, cur)) > thr
            signed = _block_reduce_mean(_host(cur) - _host(prev), block)
        packets.append(_packet(stream_id, first_frame_idx + t, changed, signed, grid_shape, block))
        prev = cur
    return packets
