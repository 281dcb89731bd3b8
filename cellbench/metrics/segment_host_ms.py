"""``segment_host_ms``: host milliseconds a segment spends in the
program's ``run_segment`` span less its ``segment.wait`` child (the host
blocked on the segment's tick count): validation, staging, the replay's
launch and realising the kept counts, masks and stats.  The mean over the
segments served outside the profiled stretch, from the program's own span
records (``cellbench/spans.py``); nothing without them."""

import numpy as np


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if not spans:
        return None
    waits: dict = {}
    for r in spans["records"]:
        if r.name == "segment.wait":
            waits[r.parent] = waits.get(r.parent, 0) + r.t1_ns - r.t0_ns
    host = [r.t1_ns - r.t0_ns - waits.get(r.id, 0) for r in spans["records"]
            if r.name == "run_segment" and not r.profiled]
    return float(np.mean(host)) / 1e6 if host else None
