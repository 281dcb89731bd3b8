"""``camera_ticks_per_s``: camera ticks served (segment ticks whose logits
reached the host), over the whole window on the host clock."""


def read(ctx):
    w = ctx.window
    return w["ticks"] / w["seconds"] if "ticks" in w and w["seconds"] > 0 else None
