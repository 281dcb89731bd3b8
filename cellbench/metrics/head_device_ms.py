"""``head_device_ms``: device milliseconds a call of the head's ops, those
after the call's last fpca kernel but its copies; only for a network."""

from cellbench.metrics._common import mean_ms, per_call


def read(ctx):
    calls = per_call(ctx)
    if not calls or not ctx.cfg["head"]:
        return None
    return mean_ms([c["after"] for c in calls])
