"""Shared arithmetic of the metric readers."""

from __future__ import annotations

import numpy as np

from cellbench.timing import split_calls


def p95(values) -> float | None:
    return float(np.percentile(np.asarray(values, np.float64), 95)) if len(values) else None


def per_call(ctx) -> list[dict] | None:
    """The traced calls' device ns by part (``timing.split_calls``), or
    None without a trace or a call."""
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    return split_calls(ctx.trace)


def mean_ms(values) -> float | None:
    return float(np.mean(values)) / 1e6 if len(values) else None
