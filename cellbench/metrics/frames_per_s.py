"""``frames_per_s``: frames whose outputs were ready, over the whole
window on the host clock."""


def read(ctx):
    w = ctx.window
    return w["frames"] / w["seconds"] if "frames" in w and w["seconds"] > 0 else None
