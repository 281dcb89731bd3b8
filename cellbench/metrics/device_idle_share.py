"""``device_idle_share``: the share of the served path's time in which no
op ran on the device, in %: one minus the device's busy time a call (the
union of its op intervals in the profiled stretch, per call there) over
the wall time a call outside the profiled stretch.  The profiler's own cost
on the host (largest on a graph launch, whose every node it instruments)
stays out of the denominator; with no unprofiled stretch the profiled
window is the denominator."""


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not w.get("traced_calls"):
        return None
    busy = tr["busy_s"] / w["traced_calls"]
    free_calls = w["calls"] - w["traced_calls"]
    wall = w["seconds"] / free_calls if free_calls else tr["window_s"] / w["traced_calls"]
    return 100.0 * (1.0 - busy / wall)
