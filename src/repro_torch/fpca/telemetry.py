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
  actuations, device-time samples), strict RFC 8259 JSON (no NaN/Infinity).

Everything costs next to nothing when disabled: ``span()`` returns one
shared null context manager, launch wrappers are a single ``is None``
check, and no hot-path code builds dicts or synchronises the device unless
a session is active.  The device hooks (``torch.profiler.record_function``
ranges, and sampled device time from a pair of CUDA events) are opt-in per
session and rate-limited, so steady-state dispatch stays asynchronous.
"""

from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import numpy as np

__all__ = [
    "MetricsRegistry",
    "MetricFamily",
    "StatsView",
    "TelemetrySession",
    "enable",
    "disable",
    "enabled",
    "session",
    "registry",
    "span",
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


class TelemetrySession:
    """One enabled telemetry run: JSONL sink + device-hook policy."""

    def __init__(self, jsonl_path: Path | str | None = None, *,
                 profile: bool = False, device_time_rate: int = 0,
                 run_labels: dict | None = None):
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        self.profile = bool(profile)
        # sample device time (a CUDA event pair, or a synchronise) on every
        # Nth instrumented launch; 0 never waits on the device.
        self.device_time_rate = int(device_time_rate)
        self.run_labels = dict(run_labels or {})
        self.events_written = 0
        self._fh = None
        self._lock = threading.Lock()
        if self.jsonl_path is not None:
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.jsonl_path, "w")
        self.event("session_start", labels=self.run_labels)

    def event(self, kind: str, **fields) -> None:
        if self._fh is None:
            self.events_written += 1
            return
        rec = {"ts": time.time(), "event": kind, **fields}
        line = json.dumps(jsonable(rec), allow_nan=False)
        with self._lock:
            self._fh.write(line + "\n")
            self.events_written += 1

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        self.event("session_end", events=self.events_written)
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


class _State(threading.local):
    def __init__(self):
        self.stack: list[str] = []


_LOCAL = _State()
_SESSION: TelemetrySession | None = None


def enable(jsonl_path: Path | str | None = None, *,
           profile: bool = False, device_time_rate: int = 0,
           run_labels: dict | None = None) -> TelemetrySession:
    """Turn telemetry on for the process (spans, JSONL, device hooks).

    Counters in stats views are *always* live (they are plain attribute
    adds); what ``enable`` switches on is the expensive part: span timing,
    JSONL event emission, and the opt-in device-profile hooks
    (``profile=True`` wraps launches in ``torch.profiler.record_function``;
    ``device_time_rate=N`` waits on every Nth launch for its device time —
    leave 0 to never wait).
    """
    global _SESSION
    if _SESSION is not None:
        _SESSION.close()
    _SESSION = TelemetrySession(jsonl_path, profile=profile,
                                device_time_rate=device_time_rate,
                                run_labels=run_labels)
    return _SESSION


def disable() -> None:
    """Close the active session (if any) and return to zero-overhead mode."""
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
    when telemetry is disabled, so the hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "fields", "t0", "_session")

    def __init__(self, sess: TelemetrySession, name: str,
                 fields: dict | None):
        self.name = name
        self.fields = fields
        self._session = sess
        self.t0 = 0.0

    def __enter__(self):
        _LOCAL.stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _LOCAL.stack
        stack.pop()
        parent = stack[-1] if stack else None
        _SPAN_HIST.labels(span=self.name).observe(dt)
        self._session.event(
            "span", span=self.name, dur_s=dt, parent=parent,
            depth=len(stack), **(self.fields or {}))
        return False


_SPAN_HIST = _REGISTRY.histogram(
    "fpca_span_seconds", "wall-clock duration of traced spans",
    ("span",), max_label_sets=64)


def span(name: str, fields: dict | None = None):
    """``with telemetry.span("serve_tick", {"stream": sid}): ...``

    Returns the shared null context manager when disabled — one module
    global ``is None`` check and nothing else.  ``fields`` is a plain
    optional dict (not ``**kwargs``) so a disabled-mode call in a tick hot
    path allocates nothing; hot call sites prebuild their label dict once
    per stream and pass the same object every tick."""
    s = _SESSION
    if s is None:
        return _NULL_SPAN
    return _Span(s, name, fields)


# --------------------------------------------------------------------------
# device-profile hooks


_LAUNCHES = _REGISTRY.counter(
    "fpca_launches_total", "instrumented executable invocations",
    ("site", "backend"), max_label_sets=128)
_DEVICE_SECONDS = _REGISTRY.histogram(
    "fpca_device_seconds", "sampled device time per launch "
    "(CUDA events; a synchronise on the host)", ("site", "backend"),
    max_label_sets=128)


def _first_tensor(out) -> Any:
    """The first tensor in a launch's output (tensors, tuples, dicts)."""
    import torch

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
    """Wrap an executable with the opt-in device-profile hooks.

    Disabled mode costs one module-global ``is None`` check per call.
    Enabled mode counts the launch; with ``profile=True`` on the session it
    runs inside ``torch.profiler.record_function`` (a named range in a
    profiler trace); with ``device_time_rate=N`` every Nth call is timed on
    the device: CUDA events recorded around it on the current stream and
    waited on (on the host, a synchronous call timed by the clock), so the
    other calls stay asynchronous.
    """
    counter = _LAUNCHES.labels(site=site, backend=backend)
    hist = _DEVICE_SECONDS.labels(site=site, backend=backend)
    tag = f"fpca:{site}:{backend}"
    state = {"n": 0}

    def launch(*args, **kwargs):
        s = _SESSION
        if s is None:
            return fn(*args, **kwargs)
        import torch

        counter.add(1)
        state["n"] += 1
        rate = s.device_time_rate
        timed = rate > 0 and state["n"] % rate == 0
        cuda = timed and torch.cuda.is_available()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        if s.profile:
            with torch.profiler.record_function(tag):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if timed:
            t = _first_tensor(out)
            if cuda and (t is None or t.is_cuda):
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                dt = time.perf_counter() - t0
            hist.observe(dt)
            s.event("device_time", site=site, backend=backend, dur_s=dt,
                    launch=state["n"])
        return out

    launch.__wrapped__ = fn
    launch._fpca_site = site
    return launch
