"""``frontend_roofline``: the frontend convolution's least time (each
frame read once, each count written once, or its ideal FLOPs: see
``roofline.py``) over the device time a call spends between the frames and
the counts (the fpca kernels and the frontend's other ops), in %."""

from cellbench import roofline
from cellbench.metrics._common import per_call


def read(ctx):
    calls = per_call(ctx)
    if not calls or "frames" not in ctx.window:
        return None
    head = bool(ctx.cfg["head"])
    ns = sum(c["fpca"] + c["before"] + (0 if head else c["after"]) for c in calls) / len(calls)
    if ns <= 0:
        return None
    work = roofline.frontend_work(ctx.cfg, ctx.traffic["batch"])
    return 100.0 * roofline.least_s(work["bytes"], work["flops"]) / (ns / 1e9)
