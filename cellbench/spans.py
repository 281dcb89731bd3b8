"""The program's own spans, read beside the profiler's trace.

* :func:`program_session` turns the program's telemetry on around a
  window (no JSONL, no device-time samples) where the program's telemetry
  keeps span records, and leaves under ``ctx.spans`` the session's span
  records and :func:`attribute` of the window's profile.  With a program without the
  span ring it turns nothing on and leaves nothing.
* :func:`attribute` puts each device op of the traced window down to the
  innermost ``fpca.*`` profiler range that holds the ``cuda*`` call that
  launched it, matched by correlation id as ``timing.reduce`` matches ops
  to calls.

The readers ``metrics/extract_device_ms.py`` and ``segment_host_ms.py``
read ``ctx.spans`` and report nothing without it.
"""

from __future__ import annotations

import contextlib
import heapq

from cellbench.timing import CALL, WINDOW

PREFIX = "fpca."


def _telemetry():
    """The program's telemetry module where it keeps span records in a ring
    on its session, else None."""
    try:
        from repro_torch.fpca import telemetry
    except ImportError:
        return None
    return telemetry if hasattr(telemetry, "RING_SIZE") else None


@contextlib.contextmanager
def program_session(ctx):
    """The program's telemetry on around the block (see the module's note);
    on leaving, ``ctx.spans`` holds ``records`` (span records), ``dropped``
    and ``attributed`` (:func:`attribute` of ``ctx.window["profile"]``, or
    None)."""
    tel = _telemetry()
    if tel is None:
        yield
        return
    sess = tel.enable()
    try:
        yield
    finally:
        tel.disable()
    prof = ctx.window.get("profile")
    ctx.spans = {"records": list(sess.spans), "dropped": sess.dropped,
                 "attributed": attribute(prof) if prof is not None else None}


def attribute(prof) -> dict:
    """Device ns of the ``cellbench.window`` range's ops by the innermost
    ``fpca.*`` range around the call that launched each (``device_ns``;
    ops launched outside every such range under ``None``), and ``calls``:
    the number of ``cellbench.call`` ranges."""
    window = None
    calls = 0
    ranges: list[tuple[int, int, str]] = []
    launched: dict[int, int] = {}        # correlation id -> host time of the launching API call
    device: list[tuple[int, int, int]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(("cellbench.", PREFIX)) and not e.is_hidden_event() and e.duration_ns() > 0:
                device.append((e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name == CALL:
            calls += 1
        elif name.startswith(PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name.startswith("cuda") and e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    if window is None:
        raise RuntimeError("the trace holds no cellbench.window range")
    w0, w1 = window
    ops = sorted((launched.get(c, s), d) for s, d, c in device if w0 <= s < w1)
    ranges.sort()
    open_: list = []
    by_range: dict = {}
    i = 0
    for t, d in ops:
        while i < len(ranges) and ranges[i][0] <= t:
            heapq.heappush(open_, (-ranges[i][0], ranges[i][1], ranges[i][2]))
            i += 1
        while open_ and open_[0][1] <= t:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else None     # the latest-opened range still open
        by_range[name] = by_range.get(name, 0) + d
    return {"device_ns": by_range, "calls": calls}
