"""``batch_ms_p95``: the 95th percentile, over every call in the window,
of the time from its dispatch (the completion of the call the loop waited
for before dispatching it) to its output being ready (CUDA events, the
device's clock)."""

from cellbench.metrics._common import p95


def read(ctx):
    return p95(ctx.window["latency_ms"]) if "frames" in ctx.window else None
