"""Adaptive streaming control plane: the keep-fraction / energy servo.

The FPCA's point is *field*-programmability — §3.4.5 region skipping and the
delta gate of :mod:`repro_torch.serving.streaming` only become deployable once the
gate threshold stops being a magic constant.  A sensor in the field must hold
a frame-rate / energy budget while the scene changes under it (the servoed
compute budget of the PPA line of work: Bose et al. 2019, Kaiser et al.
2023).  This module closes that loop:

* :class:`GateController` servos a stream's ``DeltaGateConfig.threshold``
  against a **target kept-window fraction** (or executed-energy fraction)
  per tick.  Each non-keyframe tick it observes the executed-window stats of
  the latest gate mask — the kept fraction straight from the window keep
  grid (bit-identical to
  :func:`repro_torch.core.analysis.streaming_frontend_report`'s
  ``kept_window_frac``, minus its dense-baseline work), or
  ``energy_vs_dense`` through that full report for the energy metric —
  folds them into an EMA, and applies a proportional–integral step to the
  threshold **in log space** (the block-delta statistics span decades;
  multiplicative steps behave the same at 1e-3 as at 1e-1).

* The step is **bounded** (``max_step`` nats per tick) and the threshold is
  clamped to ``[min_threshold, max_threshold]``; the integrator uses
  conditional **anti-windup** — it only accumulates while the actuator is
  unsaturated, so a long stretch pinned at a bound (e.g. an empty scene that
  can never reach the budget) does not wind up error that would overshoot for
  seconds once the scene wakes up.

* **Keyframe ticks are held out**: a keyframe keeps every block by
  construction, so its kept fraction says nothing about the threshold.  The
  controller records the tick in its history but neither updates the EMA nor
  moves the threshold.

Wiring: :meth:`repro_torch.fpca.CompiledFrontend.stream` instantiates a
controller when the program (or the call) carries a
:class:`GateControllerConfig`; the
:class:`~repro_torch.serving.streaming.StreamSession` then re-derives its own
``DeltaGateConfig`` after every frame, so each stream converges to its budget
independently.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from repro_torch.core import analysis, mapping
from repro_torch.fpca import telemetry
from repro_torch.fpca.program import GateControllerConfig

__all__ = ["GateControllerConfig", "GateController"]

# Servo observability: one labeled cell per controller, interned once at
# construction so the per-tick updates are plain attribute writes (no dict
# churn on the serving hot loop).
_G_THRESHOLD = telemetry.registry().gauge(
    "fpca_gate_threshold", "current delta-gate threshold per servo",
    ("controller",), max_label_sets=128)
_G_EMA = telemetry.registry().gauge(
    "fpca_gate_ema", "budget-metric EMA per servo", ("controller",),
    max_label_sets=128)
_G_ERR = telemetry.registry().gauge(
    "fpca_gate_servo_error", "last relative budget error per servo",
    ("controller",), max_label_sets=128)
_C_ACTUATIONS = telemetry.registry().counter(
    "fpca_gate_actuations_total", "bounded PI steps applied per servo",
    ("controller",), max_label_sets=128)


class GateController:
    """Per-stream PI servo on the delta-gate threshold (see module docstring).

    Call :meth:`observe` once per gated tick with that tick's block keep
    mask; it returns the threshold the *next* tick should gate with.  The
    trajectory is kept in :attr:`history` (one dict per tick, bounded to the
    last ``history_len`` ticks so a long-running stream does not leak) so
    benchmarks and tests can audit convergence.
    """

    def __init__(
        self,
        config: GateControllerConfig,
        spec: mapping.FPCASpec,
        threshold: float,
        const: analysis.FrontendConstants | None = None,
        name: str = "",
    ):
        self.config = config
        self.spec = spec
        self.const = const or analysis.FrontendConstants()
        self.name = name or telemetry.registry().next_instance("gate")
        self._g_thr = _G_THRESHOLD.labels(controller=self.name)
        self._g_ema = _G_EMA.labels(controller=self.name)
        self._g_err = _G_ERR.labels(controller=self.name)
        self._c_act = _C_ACTUATIONS.labels(controller=self.name)
        self.threshold = float(
            np.clip(threshold, config.min_threshold, config.max_threshold)
        )
        self._g_thr.set(self.threshold)
        self._log_thr = math.log(self.threshold)
        # dense baseline depends only on (spec, const): pay it once, not
        # per tick on the serving hot loop
        self._dense_e = analysis.frontend_energy(spec, self.const)["e_total"]
        self._ema: float | None = None
        self._integral = 0.0
        self._tick = 0
        self.history: collections.deque[dict] = collections.deque(
            maxlen=config.history_len
        )

    @property
    def ema(self) -> float | None:
        """Current budget-metric EMA (None until the first non-keyframe tick)."""
        return self._ema

    def converged_tick(self, rel_tol: float = 0.2) -> int | None:
        """First tick from which the EMA stays within ``±rel_tol`` of the
        target for the rest of the *retained* history (None = never settled)."""
        lo = self.config.target * (1.0 - rel_tol)
        hi = self.config.target * (1.0 + rel_tol)
        settled: int | None = None
        for h in self.history:
            if h["ema"] is not None and lo <= h["ema"] <= hi:
                if settled is None:
                    settled = h["tick"]
            else:
                settled = None
        return settled

    def _observation(self, block_mask: np.ndarray) -> float:
        if self.config.metric == "keep":
            # identical to streaming_frontend_report's kept_window_frac for
            # a single mask, without the dense-baseline / cycle-schedule
            # work — this runs on the host side of the serving hot loop
            return float(mapping.active_window_mask(self.spec, block_mask).mean())
        # identical to streaming_frontend_report's energy_vs_dense for a
        # single mask, with the constant dense baseline hoisted to __init__
        e = analysis.frontend_energy(self.spec, self.const, block_mask=block_mask)
        return float(e["e_total"] / self._dense_e)

    def observe(
        self,
        block_mask: np.ndarray,
        *,
        keyframe: bool = False,
        observation: float | None = None,
    ) -> float:
        """Fold one tick's gate mask into the servo; returns the new threshold.

        Keyframe ticks (mask keeps everything by construction) are recorded
        but do not move the EMA or the threshold.  ``observation`` lets a
        caller that already derived this tick's budget metric (the streaming
        server computes the window keep grid anyway) pass it in instead of
        having it re-derived from ``block_mask``.
        """
        cfg = self.config
        observed: float | None = None
        if not keyframe:
            observed = (
                observation if observation is not None
                else self._observation(block_mask)
            )
            self._ema = (
                observed
                if self._ema is None
                else cfg.ema_alpha * observed + (1.0 - cfg.ema_alpha) * self._ema
            )
            err = float(
                np.clip(
                    (self._ema - cfg.target) / cfg.target, cfg.err_low, cfg.err_high
                )
            )
            self._g_ema.set(self._ema)
            self._g_err.set(err)
            if abs(err) > cfg.deadband:
                self._actuate(err)
        self.history.append(
            {
                "tick": self._tick,
                "threshold": self.threshold,
                "observed": observed,
                "ema": self._ema,
                "keyframe": keyframe,
            }
        )
        self._tick += 1
        return self.threshold

    def _actuate(self, err: float) -> None:
        """One bounded PI step on the log-threshold (anti-windup as in
        :meth:`observe` — the integrator freezes while saturated)."""
        cfg = self.config
        u = cfg.kp * err + cfg.ki * self._integral
        step = float(np.clip(u, -cfg.max_step, cfg.max_step))
        new_log = float(
            np.clip(
                self._log_thr + step,
                math.log(cfg.min_threshold),
                math.log(cfg.max_threshold),
            )
        )
        saturated = (step != u) or (new_log != self._log_thr + step)
        self._integral = float(
            np.clip(
                cfg.leak * self._integral + (0.0 if saturated else err),
                -cfg.windup,
                cfg.windup,
            )
        )
        self._log_thr = new_log
        self.threshold = math.exp(new_log)
        self._c_act.add(1)
        self._g_thr.set(self.threshold)
        if telemetry.enabled():
            telemetry.event(
                "servo_actuate", controller=self.name, tick=self._tick,
                err=err, step=step, saturated=saturated,
                threshold=self.threshold, ema=self._ema,
            )

    def retarget(self, target: float) -> None:
        """Re-point the servo at a new budget (fleet arbitration pushes a
        fresh per-stream target at every rebalance).  EMA, integrator and
        history carry over, so the handoff is bumpless — the next
        observation simply servos toward the new target."""
        target = float(target)
        if target != self.config.target:
            # dataclasses.replace re-runs GateControllerConfig validation
            self.config = dataclasses.replace(self.config, target=target)
            if telemetry.enabled():
                telemetry.event(
                    "servo_retarget", controller=self.name,
                    tick=self._tick, target=target,
                )

    def observe_segment(
        self,
        block_masks: "np.ndarray | list",
        *,
        keyframes: "np.ndarray | list | None" = None,
        observations: "list[float | None] | None" = None,
    ) -> float:
        """Fold one device-compiled segment's per-tick gate masks into the
        servo; returns the threshold the *next segment* should gate with.

        A compiled segment serves K ticks from one launch, so the per-tick
        actuation of :meth:`observe` cannot run — the threshold is traced
        into the scan and constant for the whole segment.  This boundary
        variant keeps the EMA per-tick honest (each non-keyframe tick folds
        its own observation, keyframes held out exactly as in per-tick
        serving, all ticks recorded in :attr:`history` at the segment's
        constant threshold) and applies ONE bounded PI step at the end — so
        a K-tick segment moves the threshold at most ``max_step`` nats, the
        same actuation bound a single per-tick observation gets.
        """
        cfg = self.config
        n = len(block_masks)
        if n == 0:
            # zero-tick segment (early-exit fired before serving anything):
            # no observation was made, so neither fold the (possibly stale)
            # EMA nor spend this boundary's actuation on it — the threshold
            # must be exactly what the last real observation left it at
            return self.threshold
        for i in range(n):
            kf = bool(keyframes[i]) if keyframes is not None else False
            observed: float | None = None
            if not kf:
                obs = observations[i] if observations is not None else None
                observed = (
                    obs if obs is not None
                    else self._observation(np.asarray(block_masks[i]))
                )
                self._ema = (
                    observed
                    if self._ema is None
                    else cfg.ema_alpha * observed
                    + (1.0 - cfg.ema_alpha) * self._ema
                )
            self.history.append(
                {
                    "tick": self._tick,
                    "threshold": self.threshold,
                    "observed": observed,
                    "ema": self._ema,
                    "keyframe": kf,
                }
            )
            self._tick += 1
        if self._ema is not None:
            err = float(
                np.clip(
                    (self._ema - cfg.target) / cfg.target,
                    cfg.err_low,
                    cfg.err_high,
                )
            )
            self._g_ema.set(self._ema)
            self._g_err.set(err)
            if abs(err) > cfg.deadband:
                self._actuate(err)
        return self.threshold
