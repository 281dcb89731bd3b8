"""``step_mfu``: the whole step's share of the card's peak, in %: the least
time of a step's work (its frames in, its outputs out, its weights once,
the frontend's FLOPs on the windows it ran and the head's: ``roofline.py``)
over the wall time a step outside the profiled stretch (the whole window
when there is none).  A step is a call; a segment of the stream counts its
ticks' work and its weights once.  The share of the FLOPs alone (the
classic MFU) and of the bytes alone go to the run's notes."""

from cellbench import roofline


def read(ctx):
    w, cfg = ctx.window, ctx.cfg
    first = w["traced_calls"] if w["calls"] > w["traced_calls"] else 0
    steps = w["calls"] - first
    seconds = w["seconds"] if first or ctx.trace is None else ctx.trace["window_s"]
    if not steps or seconds <= 0:
        return None
    if "records" in w:
        nbytes = flops = 0.0
        for r in w["records"][first:]:
            kept = r[4][: r[3]]
            work = roofline.step_work(cfg, r[3], int(kept.sum()), int((kept > 0).sum()))
            nbytes += work["bytes"]
            flops += work["flops"]
    else:
        work = roofline.step_work(cfg, ctx.traffic["batch"])
        nbytes, flops = steps * work["bytes"], steps * work["flops"]
    ctx.notes.append(f"step work: {nbytes!r} bytes and {flops!r} FLOPs in {steps} steps, {seconds!r} s; "
                     f"FLOP-only share {100.0 * flops / roofline.PEAK_FLOPS / seconds!r}%, byte share "
                     f"{100.0 * nbytes / roofline.PEAK_BYTES_PER_S / seconds!r}%")
    return 100.0 * roofline.least_s(nbytes, flops) / seconds
