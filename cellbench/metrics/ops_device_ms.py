"""``ops_device_ms``: device milliseconds a call of the frontend's other
ops (window extraction, weight planes, padding, compaction, scatter): every
op of the call but the fpca kernels, the copies and, for a network, the
ops after its last fpca kernel (the head)."""

from cellbench.metrics._common import mean_ms, per_call


def read(ctx):
    calls = per_call(ctx)
    if not calls:
        return None
    head = bool(ctx.cfg["head"])
    return mean_ms([c["before"] + (0 if head else c["after"]) for c in calls])
