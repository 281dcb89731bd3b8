"""``handle_host_ms``: host milliseconds a call spends inside the handle's
``run`` (validation, padding, accounting, enqueueing the device work),
the mean over the calls outside the profiled stretch (over the profiled
ones when the window has no other)."""

import numpy as np


def read(ctx):
    spans = ctx.window.get("spans", [])
    free = [ms for ms, traced in spans if not traced] or [ms for ms, _ in spans]
    return float(np.mean(free)) if free else None
