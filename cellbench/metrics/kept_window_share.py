"""``kept_window_share``: windows the delta gate kept over the windows of
every tick served (``SegmentResult.kept_windows``), in %."""

from cellbench import roofline


def read(ctx):
    records = ctx.window.get("records")
    if not records:
        return None
    ticks = sum(r[3] for r in records)
    kept = sum(int(r[4][: r[3]].sum()) for r in records)
    return 100.0 * kept / (ticks * roofline.geometry(ctx.cfg)["windows"])
