"""``segment_ms_p95``: the 95th percentile, over every segment in the
window, of the time from its ``run_segment`` call (the completion of the
segment before, which the loop waits for) to its logits on the host (CUDA
events, the device's clock)."""

from cellbench.metrics._common import p95


def read(ctx):
    return p95(ctx.window["latency_ms"]) if "ticks" in ctx.window else None
