"""``replay_device_ms``: device milliseconds a tick of everything a
``run_segment`` call drives on the device (staging its inputs, the graph's
replay, cloning its outputs, the copies to the host), from the trace."""

from cellbench.metrics._common import per_call


def read(ctx):
    calls = per_call(ctx)
    ticks = ctx.window.get("traced_ticks")
    if not calls or not ticks:
        return None
    return sum(c["all"] for c in calls) / 1e6 / ticks
