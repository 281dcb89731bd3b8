"""``fpca_kernel_ms``: device milliseconds a call of the fpca kernels
(``fpca_tc_kernel`` or ``fpca_conv_kernel``), from the profiler's trace."""

from cellbench.metrics._common import mean_ms, per_call


def read(ctx):
    calls = per_call(ctx)
    if not calls or not any(c["fpca"] for c in calls):
        return None
    return mean_ms([c["fpca"] for c in calls])
