"""Fleet-scale budget arbitration: one envelope, many streams.

A :class:`repro_torch.serving.streaming.StreamServer` gives every stream its
own PI servo (:class:`repro_torch.serving.control.GateController`) against
its own budget, but a deployment has one device-seconds/energy envelope for
the whole camera fleet.  :class:`FleetController` closes that gap one layer
up:

* **One global budget.**  ``FleetConfig.budget`` is the summed kept-window
  (or executed-energy) fraction the fleet may spend per tick, e.g.
  ``budget=0.6`` across four streams averages 15% kept windows each,
  however unevenly arbitration splits it.

* **Priority x activity arbitration.**  Each admitted stream carries a
  priority class and an activity EMA of its realised per-tick kept
  fractions.  Every rebalance solves a water-filling split of the budget
  proportional to ``priority * activity``, clamped to ``[floor, ceiling]``
  per stream, and pushes each share into that stream's servo via
  :meth:`GateController.retarget` (bumpless: EMA and integrator state
  carry over).

* **Re-solve cadence.**  Per-tick serving rebalances every
  ``rebalance_ticks`` observed ticks; segment serving rebalances at every
  segment boundary (the only point a segment's threshold can move).

* **Admission control.**  Every admitted stream reserves at least ``floor``
  of the budget, so the fleet holds at most ``floor(budget / floor)``
  streams; past that, :meth:`add_stream` rejects (default) or queues the
  request, and :meth:`remove_stream` admits queued streams FIFO.

* **Per-tenant rollups.**  The telemetry registry carries
  ``fpca_fleet_budget``, per-stream ``fpca_fleet_allocation{stream=}`` /
  ``fpca_fleet_activity{stream=}`` gauges and admission/rebalance counters;
  :func:`repro_torch.serving.observe.fleet_report` renders the same numbers
  as an arbitration table when given the fleet.

Every fused fleet batch is one launch of the fpca_conv kernel on the card;
gate and arbitration state stay on the host.  Multi-device execution
composes underneath, not here: build the pipeline with
``FPCAPipeline(..., mesh=make_host_mesh(data=N))`` on every rank and each
fused fleet batch shards over the mesh's data axes
(:attr:`repro_torch.fpca.CompiledFrontend.data_parallelism`), while every
rank keeps its own copy of the gate and arbitration state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Mapping

from repro_torch.fpca import telemetry
from repro_torch.serving.streaming import (
    StreamFrameResult,
    StreamServer,
    StreamSession,
    _USE_SERVER,
)

__all__ = ["FleetConfig", "FleetController", "FleetAdmissionError"]

# Fleet observability: the budget is one process-wide cell; allocations and
# activities are labeled per stream (interned at admission — rebalances on
# the serving loop are plain cell writes).
_G_BUDGET = telemetry.registry().gauge(
    "fpca_fleet_budget",
    "global kept-fraction/energy budget (summed over admitted streams)")
_G_ALLOC = telemetry.registry().gauge(
    "fpca_fleet_allocation",
    "per-stream budget share pushed at the last rebalance", ("stream",),
    max_label_sets=256)
_G_ACTIVITY = telemetry.registry().gauge(
    "fpca_fleet_activity",
    "per-stream activity EMA (realised kept-window fraction)", ("stream",),
    max_label_sets=256)
_C_ADMITTED = telemetry.registry().counter(
    "fpca_fleet_admitted_total", "streams admitted into the fleet")
_C_REJECTED = telemetry.registry().counter(
    "fpca_fleet_rejected_total",
    "add_stream requests rejected or queued over budget")
_C_REBALANCES = telemetry.registry().counter(
    "fpca_fleet_rebalances_total", "global budget re-solves pushed to servos")


class FleetAdmissionError(RuntimeError):
    """The fleet is at capacity and ``admission="reject"`` (the default)."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of the global arbiter (see module docstring).

    ``budget`` is the summed per-stream budget-metric envelope;
    ``floor`` / ``ceiling`` bound any single stream's share (the floor is
    also the admission reservation: capacity = ``budget // floor``);
    ``ema_alpha`` weights the newest realised kept fraction in each
    stream's activity EMA; ``rebalance_ticks`` is the per-tick re-solve
    cadence (segment serving re-solves every boundary regardless);
    ``activity_floor`` keeps a momentarily-silent stream's arbitration
    weight positive so it can win budget back the moment its scene wakes.
    """

    budget: float = 0.6
    floor: float = 0.02
    ceiling: float = 0.9
    ema_alpha: float = 0.3
    rebalance_ticks: int = 8
    admission: str = "reject"       # "reject" | "queue"
    activity_floor: float = 1e-3

    def __post_init__(self) -> None:
        if self.budget <= 0.0:
            raise ValueError("budget must be > 0")
        if not 0.0 < self.floor <= self.ceiling <= 1.0:
            raise ValueError("need 0 < floor <= ceiling <= 1")
        if self.floor > self.budget:
            raise ValueError("floor must not exceed the budget")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if self.rebalance_ticks < 1:
            raise ValueError("rebalance_ticks must be >= 1")
        if self.admission not in ("reject", "queue"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if not 0.0 < self.activity_floor <= 1.0:
            raise ValueError("activity_floor must be in (0, 1]")


@dataclasses.dataclass
class _Member:
    """One admitted stream's arbitration state."""

    stream_id: str
    session: StreamSession
    priority: float
    activity: float | None = None   # EMA of realised kept fraction
    allocation: float = 0.0         # share pushed at the last rebalance
    ticks_observed: int = 0


def _waterfill(
    weights: Mapping[str, float], budget: float, lo: float, hi: float
) -> dict[str, float]:
    """Split ``budget`` proportionally to ``weights`` within ``[lo, hi]``.

    Every key starts at the floor; the remainder is distributed
    weight-proportionally, re-spreading whatever the ceiling claws back
    (classic water-filling — terminates because each pass caps >= 1 key).
    Sums to ``min(budget, n * hi)`` up to float error.
    """
    alloc = {k: lo for k in weights}
    rem = budget - lo * len(weights)
    active = set(weights)
    while rem > 1e-12 and active:
        wsum = sum(weights[k] for k in active)
        capped = [
            k for k in active if alloc[k] + rem * weights[k] / wsum >= hi
        ]
        if not capped:
            for k in active:
                alloc[k] += rem * weights[k] / wsum
            break
        for k in capped:
            rem -= hi - alloc[k]
            alloc[k] = hi
            active.remove(k)
    return alloc


class FleetController:
    """Global budget arbiter over one :class:`StreamServer` (module docstring).

    Streams join through :meth:`add_stream` (admission-controlled) and are
    served through :meth:`run` / :meth:`serve` / :meth:`serve_segments`,
    which fold realised kept fractions into the activity EMAs and re-solve
    the split on cadence.  Driving the underlying server directly still
    works — call :meth:`observe` / :meth:`rebalance` yourself.
    """

    def __init__(self, server: StreamServer, config: FleetConfig | None = None):
        self.server = server
        self.config = config or FleetConfig()
        self._members: dict[str, _Member] = {}
        self._queued: list[tuple[str, Any, dict]] = []
        self.rejections = 0
        self.rebalances = 0
        self._ticks_since_solve = 0
        _G_BUDGET.cell().set(self.config.budget)

    # -- membership ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Streams the budget can hold at the per-stream floor."""
        return int(self.config.budget / self.config.floor + 1e-9)

    @property
    def queued(self) -> tuple[str, ...]:
        """Stream ids waiting for admission (``admission="queue"`` only)."""
        return tuple(sid for sid, _, _ in self._queued)

    def add_stream(
        self,
        stream_id: str,
        config: Any,
        *,
        priority: float = 1.0,
        gate: Any = _USE_SERVER,
        controller: Any = _USE_SERVER,
        events: bool = False,
    ) -> StreamSession | None:
        """Admission-controlled :meth:`StreamServer.add_stream`.

        Over capacity, the request is rejected (:class:`FleetAdmissionError`)
        or — with ``admission="queue"`` — parked and admitted FIFO by
        :meth:`remove_stream`; queued requests return ``None``.  Admitted
        streams must carry a :class:`GateController` (the push target of
        every rebalance), inherit the server default or pass ``controller=``.
        ``events=True`` attaches the server's
        :class:`repro_torch.serving.events.EventTap` on admission (queued requests
        keep the flag and attach when admitted).
        """
        if priority <= 0.0:
            raise ValueError("priority must be > 0")
        if stream_id in self._members:
            raise ValueError(f"stream {stream_id!r} already admitted")
        if len(self._members) >= self.capacity:
            self.rejections += 1
            _C_REJECTED.cell().add(1)
            if self.config.admission == "queue":
                if stream_id not in self.queued:
                    self._queued.append(
                        (stream_id, config,
                         dict(priority=priority, gate=gate,
                              controller=controller, events=events))
                    )
                return None
            raise FleetAdmissionError(
                f"fleet at capacity ({self.capacity} streams x floor "
                f"{self.config.floor} fills budget {self.config.budget}); "
                f"cannot admit {stream_id!r}"
            )
        session = self.server.add_stream(
            stream_id, config, gate=gate, controller=controller, events=events
        )
        if not any(st.controller is not None for st in session._states):
            # roll the attach back — an unservoed stream has no actuator for
            # arbitration to push targets into
            self.server.sessions.pop(stream_id, None)
            self.server.event_taps.pop(stream_id, None)
            self.server._seg_fields.pop(stream_id, None)
            raise ValueError(
                f"fleet stream {stream_id!r} needs a GateController "
                "(give the server a controller= default or pass one here)"
            )
        self._members[stream_id] = _Member(
            stream_id, session, float(priority)
        )
        _C_ADMITTED.cell().add(1)
        self.rebalance()            # the newcomer gets its share immediately
        return session

    def remove_stream(self, stream_id: str) -> list[StreamSession]:
        """Detach a stream, free its share, admit queued streams FIFO.

        Returns the sessions admitted from the queue (empty when none)."""
        if self._members.pop(stream_id, None) is None:
            raise KeyError(f"stream {stream_id!r} is not admitted")
        self.server.sessions.pop(stream_id, None)
        self.server._seg_fields.pop(stream_id, None)
        self.server.event_taps.pop(stream_id, None)
        _G_ALLOC.labels(stream=stream_id).set(0.0)
        _G_ACTIVITY.labels(stream=stream_id).set(0.0)
        admitted: list[StreamSession] = []
        while self._queued and len(self._members) < self.capacity:
            sid, cfg, kw = self._queued.pop(0)
            session = self.add_stream(sid, cfg, **kw)
            if session is not None:
                admitted.append(session)
        if not admitted:
            self.rebalance()
        return admitted

    # -- observation + arbitration -------------------------------------------
    def observe(self, results: Iterable[StreamFrameResult]) -> None:
        """Fold realised results into the activity EMAs (one serve tick).

        The observation is each result's realised kept-window fraction —
        the same per-stream numbers :class:`StreamStats` sums fleet-wide —
        so a busy scene's EMA rises toward 1 and a static scene's decays
        toward its keyframe duty cycle.  Re-solves every
        ``rebalance_ticks`` calls.
        """
        a = self.config.ema_alpha
        seen: set[tuple[str, int]] = set()
        for r in results:
            m = self._members.get(r.stream_id)
            if m is None:
                continue
            kf = r.kept_fraction
            m.activity = (
                kf if m.activity is None
                else a * kf + (1.0 - a) * m.activity
            )
            # one tick per (stream, frame) — a multi-config stream yields a
            # result per config and a segment folds K ticks in one call
            if (r.stream_id, r.frame_idx) not in seen:
                seen.add((r.stream_id, r.frame_idx))
                m.ticks_observed += 1
        if seen:
            self._ticks_since_solve += 1
            if self._ticks_since_solve >= self.config.rebalance_ticks:
                self.rebalance()

    def rebalance(self) -> dict[str, float]:
        """Re-solve the split and push every share into its stream's servo.

        Weights are ``priority * max(activity, activity_floor)``; a stream
        never observed yet weighs in at full activity (its first keyframe
        keeps everything anyway).  Returns ``{stream_id: allocation}``.
        """
        cfg = self.config
        self._ticks_since_solve = 0
        members = list(self._members.values())
        if not members:
            return {}
        weights = {
            m.stream_id: m.priority * max(
                m.activity if m.activity is not None else 1.0,
                cfg.activity_floor,
            )
            for m in members
        }
        alloc = _waterfill(weights, cfg.budget, cfg.floor, cfg.ceiling)
        for m in members:
            share = alloc[m.stream_id]
            m.allocation = share
            for st in m.session._states:
                if st.controller is not None:
                    st.controller.retarget(share)
            _G_ALLOC.labels(stream=m.stream_id).set(share)
            _G_ACTIVITY.labels(stream=m.stream_id).set(
                m.activity if m.activity is not None else 0.0
            )
        self.rebalances += 1
        _C_REBALANCES.cell().add(1)
        if telemetry.enabled():
            telemetry.event(
                "fleet_rebalance", budget=cfg.budget,
                allocations={k: round(v, 6) for k, v in alloc.items()},
            )
        return alloc

    # -- serving wrappers ----------------------------------------------------
    def run(
        self, ticks: Iterable[Mapping[str, Any]]
    ) -> Iterator[list[StreamFrameResult]]:
        """:meth:`StreamServer.run` with arbitration in the loop: every
        realised tick feeds :meth:`observe` (which re-solves on cadence)."""
        for results in self.server.run(ticks):
            self.observe(results)
            yield results

    def serve(
        self, stream_id: str, frames: Iterable[Any]
    ) -> Iterator[StreamFrameResult]:
        """Single-stream convenience twin of :meth:`StreamServer.serve`."""
        for results in self.run({stream_id: f} for f in frames):
            yield from results

    def run_segment(
        self, stream_id: str, frames: Any, **kwargs
    ) -> list[StreamFrameResult]:
        """One device-compiled segment, then a boundary re-solve — the
        segment boundary is the only point a traced threshold can move, so
        arbitration always re-solves there."""
        results = self.server.run_segment(stream_id, frames, **kwargs)
        self.observe(results)
        self.rebalance()
        return results

    def serve_segments(
        self, stream_id: str, frames: Iterable[Any], **kwargs
    ) -> Iterator[StreamFrameResult]:
        """Segment-mode twin of :meth:`serve` (re-solves every boundary)."""

        def _boundary(results: list[StreamFrameResult]) -> None:
            self.observe(results)
            self.rebalance()

        yield from self.server.serve_segments(
            stream_id, frames, on_segment=_boundary, **kwargs
        )

    # -- reporting -----------------------------------------------------------
    def arbitration_table(self) -> dict:
        """Strict-JSON-able arbitration state — what
        :func:`repro_torch.serving.observe.fleet_report` embeds.
        """
        rows = []
        for m in self._members.values():
            ctl = m.session.controller
            rows.append({
                "stream": m.stream_id,
                "priority": m.priority,
                "activity": m.activity,
                "allocation": m.allocation,
                "target": None if ctl is None else ctl.config.target,
                "threshold": None if ctl is None else ctl.threshold,
                "ticks_observed": m.ticks_observed,
            })
        return telemetry.jsonable({
            "budget": self.config.budget,
            "allocated": sum(m.allocation for m in self._members.values()),
            "capacity": self.capacity,
            "admitted": len(self._members),
            "queued": list(self.queued),
            "rejections": self.rejections,
            "rebalances": self.rebalances,
            "streams": rows,
        })
