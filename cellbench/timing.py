"""The benchmark's clocks and its reading of the profiler's trace.

* :class:`Marks` marks when each call of the served path is done.  On the
  card the marks are CUDA events, the device's own clock; off the card (the
  CPU tests) host-clock readings.  A closed loop that keeps ``k`` calls in
  flight dispatches a call once it has waited for the call ``k`` places
  before, so a call's latency runs from that call's completion to its own.
* :func:`traced` records a stretch of the window under ``torch.profiler``
  inside a ``cellbench.window`` range, each call inside a ``cellbench.call``
  range; :func:`reduce` turns the raw events into device ops with their
  call, the device's busy time (the union of its op intervals), the traced
  window's length, and the idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import re
import time

import torch

WINDOW, CALL = "cellbench.window", "cellbench.call"
FPCA_KERNEL = re.compile(r"fpca_(tc|conv)_kernel")
TOP = 10


class Marks:
    """Completion marks of the calls of one stretch of a closed loop that
    keeps ``in_flight`` calls in flight; ``ms()`` their latencies.

    The loop dispatches a call just after waiting for the call
    ``in_flight`` places before it, so a call's latency runs from that
    call's completion to its own (the first calls of the stretch: from the
    stretch's start mark)."""

    def __init__(self, device: torch.device, in_flight: int = 1):
        self.cuda = device.type == "cuda"
        self.in_flight = in_flight
        self.start = None
        self.ends: list = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def dispatch(self) -> int:
        """Mark the stretch's start at its first dispatch; returns the index
        the next call's completion mark takes."""
        if self.start is None:
            self.start = self._now()
        return len(self.ends)

    def done(self) -> None:
        """Mark the last dispatched call's outputs ready, once the stream
        gets there."""
        self.ends.append(self._now())

    def wait(self, i: int) -> None:
        if self.cuda:
            self.ends[i].synchronize()

    def ms(self) -> list[float]:
        k = self.in_flight

        def span(a, b) -> float:
            return (b - a) * 1e3 if not self.cuda else a.elapsed_time(b)

        return [span(self.ends[j - k] if j >= k else self.start, end) for j, end in enumerate(self.ends)]


@contextlib.contextmanager
def traced(on: bool):
    """``torch.profiler`` over the block when ``on`` (device and host
    activity), yielding the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield prof
            if cuda:
                torch.cuda.synchronize()


def call_range():
    """The ``cellbench.call`` range one call runs in (a no-op context when
    nothing records)."""
    from torch.profiler import record_function

    return record_function(CALL)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof) -> dict:
    """The traced window as the metric readers take it.

    Returns ``window_s`` (the ``cellbench.window`` range), ``busy_s`` (the
    union of the device ops' intervals inside it), ``ops``: one
    ``(name, start_ns, end_ns, call)`` per device op (``call`` the index of
    the ``cellbench.call`` range it ran under, by start time, or -1),
    ``calls`` (the number of call ranges), and ``breakdown``: the device ops
    that took most time and the longest idle stretches by the innermost host
    activity that spans them, each at most ten ``[name, seconds]``."""
    window = None
    call_starts: list[int] = []
    host: list[tuple[int, int, str]] = []
    device: list[tuple[str, int, int, int]] = []
    launched: dict[int, int] = {}        # correlation id -> host time of the launching API call
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _is_device(e):
            if name.startswith("cellbench.") or e.is_hidden_event() or e.duration_ns() <= 0:
                continue
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name == CALL:
            call_starts.append(e.start_ns())
        else:
            if name.startswith("cuda") and e.correlation_id():
                launched[e.correlation_id()] = e.start_ns()
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no cellbench.window range")
    w0, w1 = window
    call_starts.sort()
    # an op belongs to the call whose range launched it (by its start where
    # the launch is not in the trace): with calls in flight, an op can start
    # on the device after the next call's range has begun on the host
    ops = [(n, s, e, bisect.bisect_right(call_starts, launched.get(c, s)) - 1)
           for n, s, e, c in device if w0 <= s < w1]
    merged = _merge([(s, min(e, w1)) for _, s, e, _ in ops])
    busy_ns = sum(e - s for s, e in merged)
    by_op: dict[str, int] = {}
    for n, s, e, _ in ops:
        by_op[n] = by_op.get(n, 0) + (e - s)
    gaps = []
    prev = w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": ops,
        "calls": len(call_starts),
        "breakdown": {
            "device_ops": [[n[:160], t / 1e9] for n, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": _name_gaps(gaps, host),
        },
    }


def _name_gaps(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]) -> list:
    """Sum the idle stretches by the innermost host event that spans each
    one's midpoint (the latest-starting one still open), top ten."""
    host.sort()
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    open_: list = []
    by_name: dict[str, int] = {}
    i = 0
    for mid, length in mids:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(open_, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while open_ and open_[0][1] <= mid:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "(no host event)"
        by_name[name] = by_name.get(name, 0) + length
    return [[n[:160], t / 1e9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


def split_calls(trace: dict) -> list[dict]:
    """Per call, the device ns of its fpca kernels and of its other ops
    before the first fpca kernel, after the last one, and its copies
    (``memcpy`` / ``memset``), each summed over the call."""
    calls = [{"fpca": 0, "before": 0, "after": 0, "copies": 0, "all": 0} for _ in range(trace["calls"])]
    by_call: dict[int, list] = {}
    for op in trace["ops"]:
        if op[3] >= 0:
            by_call.setdefault(op[3], []).append(op)
    for c, ops in by_call.items():
        ops.sort(key=lambda o: o[1])
        kern = {i for i, o in enumerate(ops) if FPCA_KERNEL.search(o[0])}
        first = min(kern, default=len(ops))
        last = max(kern, default=len(ops))
        for i, (name, s, e, _) in enumerate(ops):
            d = e - s
            calls[c]["all"] += d
            low = name.lower()
            if i in kern:
                calls[c]["fpca"] += d
            elif "memcpy" in low or "memset" in low:
                calls[c]["copies"] += d
            elif i < first:
                calls[c]["before"] += d
            elif i > last:
                calls[c]["after"] += d
            else:
                calls[c]["before"] += d
    return calls
