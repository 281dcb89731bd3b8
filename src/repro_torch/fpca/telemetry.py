"""Process-wide telemetry: metrics registry, span traces, device hooks (the
port's copy of the reference's ``fpca/telemetry.py``).

One substrate behind every stats surface: ``FrontendStats`` is a thin
:class:`StatsView` over registry cells, so the numbers a test reads off
``handle.stats`` and the numbers ``registry().render()`` exports are the
same cells.  Parent-chained cells single-source counters that a parent
(a pipeline) shares with its handles: a child increments one cell and the
delta propagates up the chain.

Export surfaces:

* ``registry().render()``   — Prometheus-style text snapshot.
* ``enable(jsonl_path=...)``— structured JSONL event log (spans, servo
  actuations, device-time samples), strict RFC 8259 JSON (no NaN/Infinity),
  written from memory at ``flush()`` and ``disable()``.
* ``session().spans`` / ``.samples`` — the session's bounded rings of span
  records (ids, parent, call id, start and end on the profiler's host
  clock) and device-time samples, for readers in the same process.
* ``torch.profiler`` ranges ``fpca.<span>`` and ``fpca.launch.<site>``,
  opened whenever a profiler records, with or without a session.

Everything costs next to nothing when disabled: ``span()`` returns one
shared null context manager unless a profiler records, launch wrappers are
an ``is None`` check and a profiler check, and no hot-path code builds
dicts or waits on the device.  Device time comes from CUDA event pairs
resolved at later launches without waiting, so steady-state dispatch stays
asynchronous; only ``disable()`` waits for the pairs still in flight.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import json
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "MetricsRegistry",
    "MetricFamily",
    "StatsView",
    "TelemetrySession",
    "SpanRecord",
    "DeviceSample",
    "enable",
    "disable",
    "enabled",
    "session",
    "registry",
    "span",
    "layer",
    "event",
    "instrument_launch",
    "jsonable",
    "read_jsonl",
    "OVERFLOW_LABEL",
]

# Label value substituted when a family hits its cardinality bound; the
# overflow cell keeps counting so totals stay honest even when the label
# space explodes.
OVERFLOW_LABEL = "__overflow__"

# log-spaced latency buckets (seconds); +inf bucket is implicit.
DEFAULT_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
)


# --------------------------------------------------------------------------
# strict-JSON helpers


def jsonable(obj):
    """Recursively map non-finite floats (inf / -inf / NaN) to None."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def read_jsonl(path: Path | str) -> list[dict]:
    """Parse a telemetry JSONL log back into a list of event dicts."""
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# --------------------------------------------------------------------------
# cells


class _Cell:
    """One mutable metric value.  ``parent`` chains deltas upward: a handle
    owned by a pipeline adds into its own cell and the same delta lands in
    the pipeline's cell — the single-source fix for the old double-mirrored
    ``windows_executed`` / ``launches_skipped`` counters."""

    __slots__ = ("value", "parent", "__weakref__")

    def __init__(self, value: float = 0, parent: "_Cell | None" = None):
        self.value = value
        self.parent = parent

    def add(self, delta) -> None:
        self.value += delta
        p = self.parent
        while p is not None:
            p.value += delta
            p = p.parent

    def set(self, value) -> None:
        self.value = value


class _HistCell:
    """Bounded histogram: fixed bucket edges, counts, sum and count."""

    __slots__ = ("edges", "counts", "sum", "count", "__weakref__")

    def __init__(self, edges=DEFAULT_BUCKETS):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)  # last = +inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1


# --------------------------------------------------------------------------
# metric families


class MetricFamily:
    """A named metric with a fixed label schema and bounded cardinality.

    ``labels(**kw)`` interns one cell per distinct label-value tuple.  Once
    ``max_label_sets`` distinct sets exist, further *new* sets all map to a
    single shared overflow cell (label values replaced by
    :data:`OVERFLOW_LABEL`) and ``overflowed`` counts how many sets were
    folded — totals stay correct, memory stays bounded.
    """

    def __init__(self, name: str, kind: str, help: str,
                 label_names: tuple[str, ...] = (),
                 max_label_sets: int = 64,
                 buckets=DEFAULT_BUCKETS):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help
        self.label_names = tuple(label_names)
        self.max_label_sets = max_label_sets
        self.buckets = tuple(buckets)
        self.overflowed = 0
        self._cells: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    def _new_cell(self):
        if self.kind == "histogram":
            return _HistCell(self.buckets)
        return _Cell()

    def labels(self, **kw):
        key = tuple(str(kw.get(n, "")) for n in self.label_names)
        cell = self._cells.get(key)
        if cell is not None:
            return cell
        with self._lock:
            cell = self._cells.get(key)
            if cell is not None:
                return cell
            if len(self._cells) >= self.max_label_sets:
                self.overflowed += 1
                okey = tuple(OVERFLOW_LABEL for _ in self.label_names)
                cell = self._cells.get(okey)
                if cell is None:
                    cell = self._new_cell()
                    self._cells[okey] = cell
                return cell
            cell = self._new_cell()
            self._cells[key] = cell
            return cell

    def cell(self):
        """The unlabeled cell (families declared with no label names)."""
        return self.labels()

    def samples(self) -> Iterator[tuple[dict, Any]]:
        for key, cell in self._cells.items():
            yield dict(zip(self.label_names, key)), cell


class MetricsRegistry:
    """Process-wide registry of metric families plus live stats views.

    Stats views are tracked through weakrefs so handles stay
    garbage-collectable; dead views silently drop out of ``render()`` /
    ``snapshot()``.
    """

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._views: list = []  # weakrefs to StatsView
        self._collectors: list[Callable[[], list]] = []
        self._instance_counters: dict[str, Iterator[int]] = {}
        self._lock = threading.Lock()

    # -- family constructors ------------------------------------------------

    def _family(self, name, kind, help, label_names, max_label_sets,
                buckets=DEFAULT_BUCKETS) -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, label_names,
                                   max_label_sets, buckets)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                label_names: tuple[str, ...] = (),
                max_label_sets: int = 64) -> MetricFamily:
        return self._family(name, "counter", help, label_names,
                            max_label_sets)

    def gauge(self, name: str, help: str = "",
              label_names: tuple[str, ...] = (),
              max_label_sets: int = 64) -> MetricFamily:
        return self._family(name, "gauge", help, label_names, max_label_sets)

    def histogram(self, name: str, help: str = "",
                  label_names: tuple[str, ...] = (),
                  max_label_sets: int = 64,
                  buckets=DEFAULT_BUCKETS) -> MetricFamily:
        return self._family(name, "histogram", help, label_names,
                            max_label_sets, buckets)

    # -- stats views / collectors ------------------------------------------

    def next_instance(self, prefix: str) -> str:
        with self._lock:
            c = self._instance_counters.setdefault(prefix, itertools.count())
            return f"{prefix}{next(c)}"

    def track_view(self, view: "StatsView") -> None:
        with self._lock:
            self._views.append(weakref.ref(view))

    def add_collector(self, fn: Callable[[], list]) -> None:
        """Register a pull collector returning
        ``[(name, kind, labels_dict, value), ...]`` at collect time."""
        with self._lock:
            self._collectors.append(fn)

    def live_views(self) -> list:
        out, alive = [], []
        with self._lock:
            refs = list(self._views)
        for r in refs:
            v = r()
            if v is not None:
                out.append(v)
                alive.append(r)
        with self._lock:
            self._views = alive
        return out

    # -- export -------------------------------------------------------------

    def collect(self) -> list[tuple[str, str, dict, Any]]:
        """Flatten everything into ``(name, kind, labels, value)`` rows.

        Histogram rows carry ``(sum, count, counts_by_bucket)`` tuples as
        their value; counter/gauge rows carry plain numbers.
        """
        rows: list[tuple[str, str, dict, Any]] = []
        for fam in list(self._families.values()):
            for labels, cell in fam.samples():
                if fam.kind == "histogram":
                    rows.append((fam.name, fam.kind, labels,
                                 (cell.sum, cell.count, tuple(cell.counts))))
                else:
                    rows.append((fam.name, fam.kind, labels, cell.value))
            if fam.overflowed:
                rows.append((fam.name + "_label_overflow", "counter",
                             {}, fam.overflowed))
        for view in self.live_views():
            prefix = view._PREFIX
            labels = dict(view._labels)
            for f in view._FIELDS:
                rows.append((f"{prefix}_{f}", "counter", labels,
                             view._cells[f].value))
            for f in getattr(view, "_DERIVED", ()):
                rows.append((f"{prefix}_{f}", "gauge", labels,
                             getattr(view, f)))
        for fn in list(self._collectors):
            rows.extend(fn())
        return rows

    def snapshot(self) -> dict:
        """Nested strict-JSON-able dict of every metric (for artifacts)."""
        out: dict[str, list] = {}
        for name, kind, labels, value in self.collect():
            if isinstance(value, tuple):  # histogram
                s, c, counts = value
                value = {"sum": s, "count": c, "buckets": list(counts)}
            out.setdefault(name, []).append(
                {"labels": labels, "kind": kind, "value": value})
        return jsonable(out)

    def render(self) -> str:
        """Prometheus text exposition of every family and live stats view."""
        by_name: dict[str, list] = {}
        kinds: dict[str, str] = {}
        for name, kind, labels, value in self.collect():
            by_name.setdefault(name, []).append((labels, value))
            kinds[name] = kind
        lines = []
        for name in sorted(by_name):
            kind = kinds[name]
            fam = self._families.get(name)
            if fam is not None and fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in by_name[name]:
                lab = _fmt_labels(labels)
                if kind == "histogram":
                    s, c, counts = value
                    edges = (fam.buckets if fam is not None
                             else DEFAULT_BUCKETS)
                    acc = 0
                    for edge, n in zip(edges, counts):
                        acc += n
                        lines.append(
                            f"{name}_bucket{_fmt_labels(labels, le=edge)}"
                            f" {acc}")
                    acc += counts[-1]
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels, le='+Inf')}"
                        f" {acc}")
                    lines.append(f"{name}_sum{lab} {_fmt_num(s)}")
                    lines.append(f"{name}_count{lab} {c}")
                else:
                    lines.append(f"{name}{lab} {_fmt_num(value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every family cell (cells stay interned so cached references
        held by instrumented closures keep working). Stats views are owned
        by their handles and are not touched."""
        for fam in list(self._families.values()):
            for _, cell in fam.samples():
                if isinstance(cell, _HistCell):
                    cell.counts = [0] * (len(cell.edges) + 1)
                    cell.sum = 0.0
                    cell.count = 0
                else:
                    cell.value = 0
            fam.overflowed = 0


def _fmt_labels(labels: dict, **extra) -> str:
    items = {**labels, **{k: v for k, v in extra.items()}}
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items.items())
    return "{" + body + "}"


def _fmt_num(v) -> str:
    # None is the repo-wide zero-work sentinel (undefined sample, e.g. fps
    # with nothing executed); Prometheus spells "no value" as NaN
    if v is None:
        return "NaN"
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return "NaN" if v != v else ("+Inf" if v > 0 else "-Inf")
        return repr(v)
    return str(v)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every stats object reports into."""
    return _REGISTRY


# --------------------------------------------------------------------------
# stats views


class StatsView:
    """Base for the legacy stats dataclass-alikes, now registry-backed.

    Subclasses declare ``_PREFIX`` (metric name prefix), ``_FIELDS`` (the
    counter names, in snapshot order) and optionally ``_PARENT_MAP``
    (child field -> parent field; defaults to same-name).  Attribute reads
    return cell values and ``stats.field += n`` propagates the delta up the
    parent chain, so the old ``FrontendStats``-style call sites keep
    working unchanged while every increment lands in exactly one place.
    """

    _PREFIX = "fpca_stats"
    _FIELDS: tuple[str, ...] = ()
    _PARENT_MAP: dict[str, Optional[str]] = {}
    _DERIVED: tuple[str, ...] = ()

    __slots__ = ("_cells", "_labels", "__weakref__")

    def __init__(self, parent: "StatsView | None" = None,
                 labels: dict | None = None):
        cells: dict[str, _Cell] = {}
        pcells = parent._cells if parent is not None else {}
        for f in self._FIELDS:
            pf = self._PARENT_MAP.get(f, f)
            pcell = pcells.get(pf) if pf is not None else None
            cells[f] = _Cell(0, pcell)
        object.__setattr__(self, "_cells", cells)
        lab = dict(labels or {})
        lab.setdefault("instance", _REGISTRY.next_instance(self._PREFIX))
        object.__setattr__(self, "_labels", lab)
        _REGISTRY.track_view(self)

    def __getattr__(self, name: str):
        cells = object.__getattribute__(self, "_cells")
        try:
            return cells[name].value
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}") from None

    def __setattr__(self, name: str, value) -> None:
        cell = object.__getattribute__(self, "_cells").get(name)
        if cell is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        delta = value - cell.value
        if delta:
            cell.add(delta)
        else:
            cell.value = value

    def snapshot(self) -> tuple:
        cells = object.__getattribute__(self, "_cells")
        return tuple(cells[f].value for f in self._FIELDS)

    def as_dict(self) -> dict:
        cells = object.__getattribute__(self, "_cells")
        d = {f: cells[f].value for f in self._FIELDS}
        for f in self._DERIVED:
            d[f] = getattr(self, f)
        return d

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({body})"

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsView):
            return (type(self) is type(other)
                    and self.as_dict() == other.as_dict())
        return NotImplemented

    __hash__ = object.__hash__


# --------------------------------------------------------------------------
# session / spans / events

# span records and device-time samples a session keeps in memory (each
# ring); a 51 s window of the busiest served path emits about 5e4 spans
RING_SIZE = 1 << 18
# JSONL records held before they are written (also written at flush())
_LINES_HELD = 1 << 16
# device-time event pairs in flight per launch site; a timed launch past
# this goes untimed rather than wait
MAX_PENDING = 64

# one id sequence for every span of the process: ids are unique across
# sessions and threads
_IDS = itertools.count(1)
_profiling = torch.autograd._profiler_enabled


class DeviceSample(NamedTuple):
    """One resolved device-time sample of an instrumented launch."""

    site: str
    backend: str
    dur_s: float
    launch: int        # the launch's number at its site
    profiled: bool     # a profiler was recording when it launched


class TelemetrySession:
    """One enabled telemetry run.

    Span records (:class:`SpanRecord`) and device-time samples
    (:class:`DeviceSample`) go into two bounded rings, ``spans`` and
    ``samples``; when a ring is full its oldest record goes and ``dropped``
    counts it.  JSONL records are held in memory and written, in emission
    order, at :meth:`flush` (or once ``_LINES_HELD`` are held) and at
    :meth:`close`; without a ``jsonl_path`` they are only counted.
    """

    def __init__(self, jsonl_path: Path | str | None = None, *,
                 device_time_rate: int = 0, run_labels: dict | None = None):
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        # time the device on every Nth instrumented launch: a CUDA event
        # pair resolved later without waiting (on the host, the call's
        # clock time); 0 never times
        self.device_time_rate = int(device_time_rate)
        self.run_labels = dict(run_labels or {})
        self.events_written = 0
        self.spans: collections.deque = collections.deque(maxlen=RING_SIZE)
        self.samples: collections.deque = collections.deque(maxlen=RING_SIZE)
        self.dropped = 0
        # (site, backend) -> event pairs not yet resolved, oldest first;
        # resolved pairs' events are recorded again, not made anew
        self._pending: dict[tuple[str, str], collections.deque] = {}
        self._free_events: list = []
        self._lines: list[dict] = []
        self._fh = None
        # guards the rings' drop count, the held JSONL and the event-pair
        # queues; reentrant, as resolving a pair emits its sample's event
        self._lock = threading.RLock()
        if self.jsonl_path is not None:
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.jsonl_path, "w")
        self.event("session_start", labels=self.run_labels)

    def _keep(self, ring: collections.deque, rec) -> None:
        with self._lock:
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(rec)

    def event(self, kind: str, **fields) -> None:
        with self._lock:
            self.events_written += 1
            if self._fh is None:
                return
            self._lines.append({"ts": time.time(), "event": kind, **fields})
            full = len(self._lines) >= _LINES_HELD
        if full:
            self._write()

    def _write(self) -> None:
        with self._lock:
            lines, self._lines = self._lines, []
            if self._fh is None:
                return
            for rec in lines:
                self._fh.write(json.dumps(jsonable(rec), allow_nan=False) + "\n")
            self._fh.flush()

    def _sample(self, site: str, backend: str, dur_s: float, launch: int,
                profiled: bool) -> None:
        _DEVICE_SECONDS.labels(site=site, backend=backend).observe(dur_s)
        self._keep(self.samples, DeviceSample(site, backend, dur_s, launch, profiled))
        self.event("device_time", site=site, backend=backend, dur_s=dur_s,
                   launch=launch)

    def _resolve(self, key: tuple[str, str], *, wait: bool = False) -> None:
        """Turn the finished event pairs of ``key``'s launches into samples,
        oldest first, up to the first that has not finished (``wait``: all
        of them, waiting for each)."""
        with self._lock:
            queue = self._pending.get(key)
            while queue:
                start, end, launch, profiled = queue[0]
                if wait:
                    end.synchronize()
                elif not end.query():
                    return
                queue.popleft()
                self._sample(*key, start.elapsed_time(end) / 1e3, launch, profiled)
                self._free_events += (start, end)

    def _event(self):
        return self._free_events.pop() if self._free_events else torch.cuda.Event(enable_timing=True)

    def _start(self, key: tuple[str, str]):
        """A start event recorded now for a timed launch of ``key`` on the
        card, once ``key``'s finished pairs are resolved; None while
        :data:`MAX_PENDING` of its pairs are in flight."""
        with self._lock:
            self._resolve(key)
            if len(self._pending.setdefault(key, collections.deque())) >= MAX_PENDING:
                return None
            start = self._event()
            start.record()
            return start

    def _end(self, key: tuple[str, str], start, launch: int, profiled: bool) -> None:
        """Queue ``start``'s pair, its end event recorded now."""
        with self._lock:
            end = self._event()
            end.record()
            self._pending[key].append((start, end, launch, profiled))

    def _unused(self, start) -> None:
        """Take back a start event whose launch left its output on the host."""
        with self._lock:
            self._free_events.append(start)

    def flush(self) -> None:
        """Resolve the device-time pairs that have finished, without
        waiting, and write the JSONL held so far."""
        for key in list(self._pending):
            self._resolve(key)
        self._write()

    def close(self) -> None:
        for key in list(self._pending):
            self._resolve(key, wait=True)
        self.event("session_end", events=self.events_written)
        self._write()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class _State(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []


_LOCAL = _State()
_SESSION: TelemetrySession | None = None


def enable(jsonl_path: Path | str | None = None, *,
           device_time_rate: int = 0,
           run_labels: dict | None = None) -> TelemetrySession:
    """Turn telemetry on for the process (spans, JSONL, device time).

    Counters in stats views are *always* live (they are plain attribute
    adds); what ``enable`` switches on is span timing into the session's
    rings, JSONL event emission, and ``device_time_rate=N``: a device-time
    sample of every Nth instrumented launch (CUDA events resolved later, so
    nothing waits on the card until :func:`disable`; leave 0 to time
    nothing).  Profiler ranges need no session: every span opens one while
    a ``torch.profiler`` records.
    """
    global _SESSION
    if _SESSION is not None:
        _SESSION.close()
    _SESSION = TelemetrySession(jsonl_path, device_time_rate=device_time_rate,
                                run_labels=run_labels)
    return _SESSION


def disable() -> None:
    """Close the active session (if any: it waits for the device-time pairs
    still in flight and writes its JSONL) and return to zero-overhead
    mode."""
    global _SESSION
    if _SESSION is not None:
        _SESSION.close()
        _SESSION = None


def enabled() -> bool:
    return _SESSION is not None


def session() -> TelemetrySession | None:
    return _SESSION


def event(kind: str, **fields) -> None:
    """Emit one JSONL event if telemetry is enabled; no-op otherwise."""
    s = _SESSION
    if s is not None:
        s.event(kind, **fields)


class _NullSpan:
    """Shared no-op context manager: ``span()`` returns this exact object
    when telemetry is disabled and no profiler records, so the hot path
    allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _range(name: str):
    """A profiler range named ``name``.  Function-scoped: the profiler
    keeps it on the host's timeline only, where a ``record_function`` range
    would also get a copy among the device's ops (``gpu_user_annotation``)."""
    return torch._C._profiler._RecordFunctionFast(name)


class SpanRecord(NamedTuple):
    """One finished span, as its session's ``spans`` ring keeps it.

    ``id`` is unique in the process; ``parent`` is the enclosing span's id
    (``parent_name`` its name, ``depth`` the number of enclosing spans);
    ``call`` is the id of the outermost span, shared by every span of one
    API call.  ``t0_ns`` / ``t1_ns`` are Unix-epoch nanoseconds, the clock
    the torch profiler stamps host events with; ``profiled`` says whether a
    profiler was recording when the span was entered (it then ran inside
    the profiler range ``fpca.<name>``).  A tuple of plain values: the
    garbage collector stops tracking it, so a full ring costs no
    collection time."""

    name: str
    id: int
    parent: Optional[int]
    parent_name: Optional[str]
    depth: int
    call: int
    t0_ns: int
    t1_ns: int
    profiled: bool

    @property
    def dur_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class _Span:
    """A span while it is open: the context manager :func:`span` and
    :func:`layer` return with a session.  A layer span (``jsonl`` False)
    writes no JSONL line."""

    __slots__ = ("name", "fields", "jsonl", "id", "parent", "parent_name",
                 "depth", "call", "t0_ns", "profiled", "_session", "_range")

    def __init__(self, sess: TelemetrySession, name: str,
                 fields: dict | None, jsonl: bool):
        self.name = name
        self.fields = fields
        self.jsonl = jsonl
        self._session = sess

    def __enter__(self):
        stack = _LOCAL.stack
        self.id = next(_IDS)
        if stack:
            outer = stack[-1]
            self.parent, self.parent_name, self.call = outer.id, outer.name, outer.call
        else:
            self.parent = self.parent_name = None
            self.call = self.id
        self.depth = len(stack)
        stack.append(self)
        self.profiled = _profiling()
        self.t0_ns = time.time_ns()
        self._range = _range("fpca." + self.name) if self.profiled else None
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        rec = SpanRecord(self.name, self.id, self.parent, self.parent_name, self.depth,
                         self.call, self.t0_ns, time.time_ns(), self.profiled)
        _LOCAL.stack.pop()
        dt = rec.dur_s
        _SPAN_HIST.labels(span=self.name).observe(dt)
        s = self._session
        s._keep(s.spans, rec)
        if self.jsonl:
            s.event(
                "span", span=self.name, dur_s=dt, parent=self.parent_name,
                depth=self.depth, id=self.id, parent_id=self.parent,
                call=self.call, t0_ns=rec.t0_ns, t1_ns=rec.t1_ns,
                profiled=self.profiled, **(self.fields or {}))
        return False


_SPAN_HIST = _REGISTRY.histogram(
    "fpca_span_seconds", "wall-clock duration of traced spans",
    ("span",), max_label_sets=64)


def span(name: str, fields: dict | None = None):
    """``with telemetry.span("serve_tick", {"stream": sid}): ...``

    With a session: a span whose :class:`SpanRecord` goes to the ring, its
    time to ``fpca_span_seconds``, one JSONL line, and the profiler range
    ``fpca.<name>`` while a profiler records.  Without one: the range alone while a profiler records, else
    the shared null context manager — one module-global ``is None`` check
    and one profiler check, nothing allocated.  ``fields`` is a plain
    optional dict (not ``**kwargs``) so a disabled-mode call in a tick hot
    path allocates nothing; hot call sites prebuild their label dict once
    per stream and pass the same object every tick."""
    s = _SESSION
    if s is None:
        return _range("fpca." + name) if _profiling() else _NULL_SPAN
    return _Span(s, name, fields, True)


def layer(name: str):
    """A span at a layer boundary inside one call (``prepare``,
    ``encode``, ``extract``, ``kernel``, ``segment.wait``, ...): kept in the
    ring, timed into ``fpca_span_seconds`` and ranged for the profiler like
    :func:`span`, but it writes no JSONL line, so the event stream stays
    the API's."""
    s = _SESSION
    if s is None:
        return _range("fpca." + name) if _profiling() else _NULL_SPAN
    return _Span(s, name, None, False)


# --------------------------------------------------------------------------
# device-profile hooks


_LAUNCHES = _REGISTRY.counter(
    "fpca_launches_total", "instrumented executable invocations",
    ("site", "backend"), max_label_sets=128)
_DEVICE_SECONDS = _REGISTRY.histogram(
    "fpca_device_seconds", "sampled device time per launch "
    "(CUDA events; the call's clock time on the host)", ("site", "backend"),
    max_label_sets=128)


def _first_tensor(out) -> Any:
    """The first tensor in a launch's output (tensors, tuples, dicts)."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def instrument_launch(fn: Callable, *, site: str, backend: str) -> Callable:
    """Wrap an executable with the device-profile hooks.

    With no session and no profiler it costs one module-global ``is None``
    check and one profiler check a call.  While a profiler records, the
    call runs inside the range ``fpca.launch.<site>``.  With a session the
    launch is counted, and with ``device_time_rate=N`` every Nth call is
    timed: on the card a CUDA event pair recorded around it on the current
    stream, resolved at a later launch of the site, at ``flush()`` or at
    ``disable()`` (the one place that waits), with at most
    :data:`MAX_PENDING` pairs in flight (a launch past that goes untimed);
    on the host the call's clock time.  So every call stays asynchronous.
    """
    counter = _LAUNCHES.labels(site=site, backend=backend)
    tag = f"fpca.launch.{site}"
    key = (site, backend)
    state = {"n": 0}

    def launch(*args, **kwargs):
        s = _SESSION
        if s is None:
            if not _profiling():
                return fn(*args, **kwargs)
            with _range(tag):
                return fn(*args, **kwargs)
        counter.add(1)
        state["n"] += 1
        n = state["n"]
        profiled = _profiling()
        rate = s.device_time_rate
        timed = rate > 0 and n % rate == 0
        start = None
        if timed and torch.cuda.is_available():
            start = s._start(key)
            timed = start is not None
        t0 = time.perf_counter()
        if profiled:
            with _range(tag):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if timed:
            t = _first_tensor(out)
            if start is not None and (t is None or t.is_cuda):
                s._end(key, start, n, profiled)
            else:
                if start is not None:
                    s._unused(start)
                s._sample(site, backend, time.perf_counter() - t0, n, profiled)
        return out

    launch.__wrapped__ = fn
    launch._fpca_site = site
    return launch
