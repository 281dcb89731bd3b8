"""``setup_s``: host seconds from the start of the process to the opening
of the measured window: imports, the calibration, weights and frames from
the seed, compiling the handle, building the kernels (the first run of a
checkout) and the warm-up that serves every shape and captures every graph
the window uses."""


def read(ctx):
    return ctx.setup_s
