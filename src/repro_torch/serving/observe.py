"""Fleet observability: per-(stream, config) serving report and
reconciliation.

The third telemetry export surface (next to ``registry().render()`` and the
JSONL event log): :func:`fleet_report` folds a :class:`StreamServer`'s
sessions, servo controllers, executable cache and registry-backed counters
into one strict-JSON-able table, what a dashboard reads per scrape.

Every stats surface is a :class:`repro_torch.fpca.telemetry.StatsView` over
shared registry cells, so the report needs no delta bookkeeping of its own;
:func:`assert_reconciled` makes that contract executable: the counter
objects, the registry export and the parent-chained handle cells must agree
exactly, every time.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core import analysis
from repro_torch.fpca import telemetry

__all__ = ["fleet_report", "render_fleet_report", "assert_reconciled"]


def _stream_rows(server, const) -> list[dict]:
    rows: list[dict] = []
    for stream_id, session in server.sessions.items():
        for cfg_name in session.configs:
            row: dict[str, Any] = {
                "stream": stream_id,
                "config": cfg_name,
                "frames": session.frame_idx,
                "gated": session.gating,
            }
            st = session.state_for(cfg_name)
            if st is not None and st.block_masks:
                rep = session.energy_report(const, config=cfg_name)
                row.update(
                    kept_window_frac=rep["kept_window_frac"],
                    executed_windows=rep["executed_windows"],
                    executed_cycles=rep["executed_cycles"],
                    e_total=rep["e_total"],
                    energy_vs_dense=rep["energy_vs_dense"],
                    latency_vs_dense=rep["latency_vs_dense"],
                    fps_effective=rep["fps_effective"],
                )
            ctl = st.controller if st is not None else None
            if ctl is not None:
                row.update(
                    servo={
                        "controller": ctl.name,
                        "metric": ctl.config.metric,
                        "target": ctl.config.target,
                        "threshold": ctl.threshold,
                        "ema": ctl.ema,
                        "converged_tick": ctl.converged_tick(),
                        "ticks": len(ctl.history),
                    }
                )
            rows.append(row)
    return rows


def fleet_report(
    server,
    const: analysis.FrontendConstants | None = None,
    fleet=None,
) -> dict:
    """Per-(stream, config) serving table plus fleet-level totals.

    Every number is either a live registry cell read (:class:`StreamStats`
    / :class:`PipelineStats` fields, cache counters) or derived from the
    per-session gate history through
    :func:`repro_torch.core.analysis.streaming_frontend_report` — nothing is
    sampled or mirrored, so the report reconciles exactly with the legacy
    stats objects (see :func:`assert_reconciled`).  Strict-JSON-able
    (non-finite floats map to ``None`` via
    :func:`repro_torch.fpca.telemetry.jsonable`).

    With a :class:`repro_torch.serving.fleet.FleetController` passed as
    ``fleet``, the report also carries its ``arbitration`` table — budget,
    per-stream priority/activity/allocation and admission counters.

    The ``workloads`` table breaks the fleet out per architecture: every
    arch-labeled ``fpca_model_*`` / ``fpca_events_*`` registry row (model
    zoo classifier/detector traffic, neuromorphic event lanes), summed
    across instances.
    """
    s = server.stats
    pipe = server.pipeline
    info = pipe.cache_info()
    gets = info.hits + info.misses
    fleet_totals = {
        "ticks": s.ticks,
        "frames": s.frames,
        "windows_total": s.windows_total,
        "windows_kept": s.windows_kept,
        "kept_fraction": s.windows_kept / max(s.windows_total, 1),
        "launches_skipped": s.launches_skipped,
        "bucket_switches": s.bucket_switches,
        "bucket_shrinks_deferred": s.bucket_shrinks_deferred,
        "segments": s.segments,
        "segment_ticks": s.segment_ticks,
        "fused_head_calls": s.fused_head_calls,
        "serve_seconds": s.serve_seconds,
        "fps_wall": (
            s.frames / s.serve_seconds if s.serve_seconds > 0 else None
        ),
        "cache": {
            "hits": info.hits,
            "misses": info.misses,
            "hit_rate": info.hits / gets if gets else None,
            "evictions": info.evictions,
            "currsize": info.currsize,
            "maxsize": info.maxsize,
        },
    }
    report = {
        "streams": _stream_rows(server, const),
        "fleet": fleet_totals,
        "workloads": _workload_rows(),
    }
    if fleet is not None:
        report["arbitration"] = fleet.arbitration_table()
    return telemetry.jsonable(report)


def _workload_rows() -> dict[str, dict[str, float]]:
    """Per-architecture workload breakout: every arch-labeled registry row
    (the ``fpca_model_*`` run/frame counters stamped by
    :class:`repro_torch.fpca.CompiledModel` and the ``fpca_events_*`` lanes of
    attached :class:`repro_torch.serving.events.EventTap`\\ s), summed across
    instances.  Registry-global by design — one dashboard row per workload
    kind regardless of how many compiled handles serve it."""
    workloads: dict[str, dict[str, float]] = {}
    for name, _kind, labels, value in telemetry.registry().collect():
        arch = labels.get("arch")
        if arch is None:
            continue
        if not (name.startswith("fpca_model_")
                or name.startswith("fpca_events_")):
            continue
        row = workloads.setdefault(arch, {})
        row[name] = row.get(name, 0) + value
    return workloads


_COLS = (
    ("stream", "stream"),
    ("config", "config"),
    ("frames", "frames"),
    ("kept_window_frac", "kept"),
    ("energy_vs_dense", "e/dense"),
    ("fps_effective", "fps_eff"),
)


def render_fleet_report(report: dict) -> str:
    """Plain-text table of a :func:`fleet_report` result (for CLI output)."""

    def _fmt(v) -> str:
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    rows = []
    for r in report["streams"]:
        servo = r.get("servo")
        rows.append(
            [_fmt(r.get(key)) for key, _ in _COLS]
            + [
                _fmt(servo["threshold"]) if servo else "-",
                _fmt(servo["converged_tick"]) if servo else "-",
            ]
        )
    headers = [h for _, h in _COLS] + ["thr", "conv@"]
    widths = [
        max(len(h), *(len(row[i]) for row in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    lines = [
        "  ".join(h.ljust(w) for h, w in zip(headers, widths)),
        "  ".join("-" * w for w in widths),
    ]
    for row in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    f = report["fleet"]
    lines.append(
        f"fleet: {f['frames']} frames in {f['ticks']} ticks, "
        f"kept {f['kept_fraction']:.3f}, "
        f"cache hit-rate {_fmt(f['cache']['hit_rate'])}, "
        f"wall fps {_fmt(f['fps_wall'])}"
    )
    arb = report.get("arbitration")
    if arb:
        lines.append(
            f"arbitration: budget {_fmt(arb['budget'])} "
            f"(allocated {_fmt(arb['allocated'])}), "
            f"{arb['admitted']}/{arb['capacity']} streams admitted, "
            f"{len(arb['queued'])} queued, {arb['rejections']} rejected, "
            f"{arb['rebalances']} rebalances"
        )
        for r in arb["streams"]:
            lines.append(
                f"  {r['stream']}: prio {_fmt(r['priority'])}  "
                f"activity {_fmt(r['activity'])}  "
                f"allocation {_fmt(r['allocation'])}  "
                f"thr {_fmt(r['threshold'])}"
            )
    return "\n".join(lines)


def _registry_rows_for(view: telemetry.StatsView) -> dict[str, Any]:
    """The registry's exported rows for one stats view, keyed by field."""
    prefix = view._PREFIX
    inst = view._labels.get("instance")
    out: dict[str, Any] = {}
    for name, _kind, labels, value in telemetry.registry().collect():
        if labels.get("instance") == inst and name.startswith(prefix + "_"):
            out[name[len(prefix) + 1:]] = value
    return out


def assert_reconciled(pipeline, server=None) -> None:
    """Assert the three stats surfaces agree *exactly* — no tolerance.

    1. Registry export rows == legacy attribute reads, for
       :class:`PipelineStats` (and :class:`StreamStats` when a server is
       given) — they are the same cells, so any drift is a wiring bug.
    2. The pipeline's ``windows_executed`` / ``launches_skipped`` /
       ``windows_total`` equal the sum over its compiled handles' cells —
       the parent-chain single-sourcing contract (no double counting, no
       missed increments).
    3. Derived cache counters == :meth:`ExecutableCache.info`.
    4. Event-tap accounting (server streams with ``events=True``): the
       polarity split sums to the event total, and the tap's event count
       equals the gate's own changed-block count — per-tick and
       segment-reconstructed packets both honour it.
    """
    views = [pipeline.stats] + ([server.stats] if server is not None else [])
    taps = list(getattr(server, "event_taps", {}).values()) if server else []
    views.extend(t.stats for t in taps)
    for view in views:
        exported = _registry_rows_for(view)
        legacy = view.as_dict()
        for field, value in legacy.items():
            assert field in exported, (
                f"{type(view).__name__}.{field} missing from registry export"
            )
            assert exported[field] == value, (
                f"{type(view).__name__}.{field}: registry export "
                f"{exported[field]} != legacy counter {value}"
            )
    chained = ("windows_total", "windows_executed", "launches_skipped",
               "bucket_switches", "bucket_shrinks_deferred",
               "segments", "segment_ticks")
    handles = [
        h for h in pipeline._handles.values()
        if isinstance(getattr(h, "stats", None), telemetry.StatsView)
    ]
    for field in chained:
        total = sum(getattr(h.stats, field) for h in handles)
        have = getattr(pipeline.stats, field)
        assert total == have, (
            f"parent-chain mismatch on {field}: handles sum to {total}, "
            f"pipeline cell holds {have}"
        )
    info = pipeline.cache_info()
    assert pipeline.stats.cache_hits == info.hits
    assert pipeline.stats.cache_misses == info.misses
    assert pipeline.stats.evictions == info.evictions
    for tap in taps:
        es = tap.stats
        assert es.events == es.events_pos + es.events_neg, (
            f"event polarity split {es.events_pos}+{es.events_neg} != "
            f"total {es.events} on stream {tap.session.stream_id!r}"
        )
        st = tap.session._primary
        assert st is not None and es.events == st.changed_total, (
            f"event stream {tap.session.stream_id!r}: tap counted "
            f"{es.events} events, gate counted "
            f"{st.changed_total if st is not None else None} changed blocks"
        )
