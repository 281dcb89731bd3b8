"""The port's span records, profiler ranges and device-time queue
(``repro_torch.fpca.telemetry``), on the host.

* span records carry an id, the parent's id and the call's id, and land in
  a bounded ring; layer spans write no JSONL line;
* with no session and no profiler nothing is allocated and no profiler
  range opens; under a ``torch.profiler`` every span opens ``fpca.<name>``,
  nested as the spans are, on the clock the spans are stamped with;
* the layer spans of a served call (``run > prepare, encode, extract,
  planes, kernel, head``) and of a segment (``run_segment > segment.wait,
  segment.realise``);
* a device-time pair is resolved at a later launch once it has finished,
  and only ``disable()`` waits (stub CUDA events).

The JSONL stream itself stays the reference's: ``tests/test_torch_streaming.py``
and ``tests/test_torch_examples.py`` compare it event for event.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import fpca
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.mapping import FPCASpec
from repro_torch.fpca import telemetry

pytestmark = pytest.mark.telemetry

SPEC = FPCASpec(image_h=16, image_w=16, out_channels=4, kernel=2, stride=2, max_kernel=2)


@pytest.fixture(autouse=True)
def _no_leaked_session():
    yield
    telemetry.disable()


@pytest.fixture(scope="module")
def model():
    return fit_bucket_model(n_pixels=SPEC.n_active_pixels, grid=9, device="cpu")


def _network(model, gate=None):
    rng = np.random.default_rng(0)
    program = fpca.FPCAModelProgram(
        frontend=fpca.FPCAProgram(spec=SPEC, gate=gate),
        head=(fpca.DenseSpec(5, activation="relu"), fpca.DenseSpec(2)),
    )
    d = 8 * 8 * SPEC.out_channels
    head = [{"w": torch.from_numpy(rng.normal(size=(d, 5)).astype(np.float32) * 0.05), "b": torch.zeros(5)},
            {"w": torch.from_numpy(rng.normal(size=(5, 2)).astype(np.float32)), "b": torch.zeros(2)}]
    kernel = torch.from_numpy(rng.normal(size=(SPEC.out_channels, 2, 2, 3)).astype(np.float32))
    return fpca.compile(program, backend="basis", device="cpu", model=model, weights=kernel, head_params=head)


def _frames(n: int, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random((n, 16, 16, 3), dtype=np.float32))


def test_span_records_carry_ids_parents_and_the_call_id(tmp_path):
    sess = telemetry.enable(tmp_path / "s.jsonl")
    with telemetry.span("outer", {"k": 1}):
        with telemetry.span("inner"):
            with telemetry.layer("leaf"):
                pass
    with telemetry.span("outer"):
        pass
    telemetry.disable()
    leaf, inner, outer, second = sess.spans
    assert [r.name for r in sess.spans] == ["leaf", "inner", "outer", "outer"]
    assert len({r.id for r in sess.spans}) == 4
    assert (outer.parent, inner.parent, leaf.parent) == (None, outer.id, inner.id)
    assert (inner.parent_name, leaf.parent_name, leaf.depth) == ("outer", "inner", 2)
    assert outer.call == inner.call == leaf.call == outer.id != second.call == second.id
    assert all(r.t0_ns <= r.t1_ns and not r.profiled for r in sess.spans)
    assert outer.t0_ns <= inner.t0_ns <= leaf.t0_ns <= leaf.t1_ns <= inner.t1_ns <= outer.t1_ns
    lines = [e for e in telemetry.read_jsonl(tmp_path / "s.jsonl") if e["event"] == "span"]
    assert [e["span"] for e in lines] == ["inner", "outer", "outer"]      # the layer span writes none
    assert lines[0]["parent_id"] == outer.id and lines[0]["call"] == outer.id and lines[1]["k"] == 1
    assert (lines[0]["t0_ns"], lines[0]["t1_ns"], lines[0]["profiled"]) == (inner.t0_ns, inner.t1_ns, False)
    assert sess.events_written == len(telemetry.read_jsonl(tmp_path / "s.jsonl"))


def test_jsonl_is_written_from_memory_at_flush(tmp_path):
    path = tmp_path / "s.jsonl"
    sess = telemetry.enable(path)
    with telemetry.span("a"):
        pass
    assert path.read_text() == ""
    sess.flush()
    assert [e["event"] for e in telemetry.read_jsonl(path)] == ["session_start", "span"]
    telemetry.disable()
    assert [e["event"] for e in telemetry.read_jsonl(path)] == ["session_start", "span", "session_end"]


def test_the_ring_keeps_the_newest_records_and_counts_the_dropped(monkeypatch):
    assert telemetry.RING_SIZE >= 2**18
    monkeypatch.setattr(telemetry, "RING_SIZE", 4)
    sess = telemetry.enable()
    for i in range(10):
        with telemetry.layer(f"s{i}"):
            pass
    assert [r.name for r in sess.spans] == ["s6", "s7", "s8", "s9"]
    assert sess.dropped == 6 and sess.spans.maxlen == 4


def test_with_no_session_and_no_profiler_nothing_is_allocated_or_ranged(monkeypatch):
    opened = []
    monkeypatch.setattr(telemetry, "_range", lambda name: opened.append(name))
    assert telemetry.span("x") is telemetry.span("y") is telemetry.layer("z") is telemetry._NULL_SPAN
    fn = telemetry.instrument_launch(lambda x: x + 1, site="s", backend="b")
    assert fn(1) == 2
    assert opened == []


def _ranges(prof) -> dict:
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fpca."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns(), str(e.device_type())))
    return out


def test_profiler_ranges_nest_as_the_spans_do_on_their_clock():
    fn = telemetry.instrument_launch(lambda x: x * 2, site="site", backend="b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("warm"):                # the profiler's first range costs most
            pass
        sess = telemetry.enable()
        with telemetry.span("outer"):
            with telemetry.layer("inner"):
                fn(torch.ones(4))
        telemetry.disable()
        with telemetry.span("bare"):                # no session: the range alone
            pass
    ranges = _ranges(prof)
    assert set(ranges) == {"fpca.warm", "fpca.outer", "fpca.inner", "fpca.launch.site", "fpca.bare"}
    assert all(len(v) == 1 and v[0][2].endswith("CPU") for v in ranges.values())
    (o0, o1, _), (i0, i1, _), (l0, l1, _) = (ranges[f"fpca.{n}"][0] for n in ("outer", "inner", "launch.site"))
    assert o0 <= i0 <= l0 <= l1 <= i1 <= o1
    inner, outer = sess.spans
    assert inner.profiled and outer.profiled and inner.parent == outer.id
    for rec in (inner, outer):
        r0, r1, _ = ranges["fpca." + rec.name][0]
        assert abs(rec.t0_ns - r0) < 1_000_000 and abs(rec.t1_ns - r1) < 1_000_000


def test_a_model_run_spans_prepare_encode_extract_planes_kernel_and_head(model):
    handle = _network(model)
    sess = telemetry.enable()
    handle.run(_frames(3))
    telemetry.disable()
    by_start = sorted(sess.spans, key=lambda r: (r.t0_ns, r.id))
    assert [r.name for r in by_start] == ["run", "prepare", "encode", "extract", "planes", "kernel", "head"]
    run = by_start[0]
    assert all(r.parent == run.id and r.call == run.id for r in by_start[1:])
    names = {labels["span"] for name, _, labels, _ in telemetry.registry().collect() if name == "fpca_span_seconds"}
    assert names >= {"run", "prepare", "encode", "extract", "planes", "kernel", "head"}


def test_a_masked_call_spans_compact_and_scatter(model):
    handle = _network(model)
    keep = np.zeros((2, 8, 8), bool)
    keep[:, :3] = True
    sess = telemetry.enable()
    handle.run(_frames(2), window_keep=keep)
    telemetry.disable()
    names = [r.name for r in sorted(sess.spans, key=lambda r: r.id)]
    assert names == ["run", "prepare", "encode", "extract", "planes", "compact", "kernel", "scatter", "head"]


def test_a_segment_spans_its_wait_and_its_host_part(model, tmp_path):
    handle = _network(model, gate=fpca.DeltaGateConfig(threshold=0.02))
    path = tmp_path / "s.jsonl"
    sess = telemetry.enable(path)
    res = handle.run_segment(_frames(3))
    handle.run_segment(_frames(3, seed=2), state=res.state)
    telemetry.disable()
    segments = [r for r in sess.spans if r.name == "run_segment"]
    assert len(segments) == 2
    for seg in segments:
        children = [r.name for r in sorted(sess.spans, key=lambda r: r.id) if r.parent == seg.id]
        # on the host the tick body runs eagerly: each tick's frontend steps, then the host's part
        assert children[-2:] == ["segment.wait", "segment.realise"]
        assert children[:-2] == ["encode", "extract", "planes", "compact", "kernel", "scatter"] * 3
    lines = [e for e in telemetry.read_jsonl(path) if e["event"] == "span"]
    assert [(e["span"], e["model"]) for e in lines] == [("run_segment", True)] * 2


class _StubEvent:
    """A CUDA event as the queue sees it: ``done`` decides ``query``."""

    made: list = []
    waits = 0

    def __init__(self, enable_timing=False):
        self.done = False
        self.at = len(_StubEvent.made)
        _StubEvent.made.append(self)

    def record(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        _StubEvent.waits += 1
        self.done = True

    def elapsed_time(self, end):
        return float(end.at - self.at)           # ms


@pytest.fixture
def stub_card(monkeypatch):
    _StubEvent.made, _StubEvent.waits = [], 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("the queue synchronised the card"))
    return _StubEvent


def test_device_time_pairs_resolve_at_later_launches_without_waiting(stub_card, tmp_path):
    path = tmp_path / "s.jsonl"
    sess = telemetry.enable(path, device_time_rate=1)
    fn = telemetry.instrument_launch(lambda: {"out": 1}, site="segment", backend="cuda")
    fn(), fn(), fn()
    assert not sess.samples and len(stub_card.made) == 6
    stub_card.made[1].done = stub_card.made[3].done = True     # the first two launches' ends
    fn()                                                         # resolves them, waits for none
    assert [(s.launch, s.dur_s) for s in sess.samples] == [(1, 1e-3), (2, 1e-3)]
    stub_card.made[5].done = True
    sess.flush()
    assert [s.launch for s in sess.samples] == [1, 2, 3] and stub_card.waits == 0
    telemetry.disable()                                          # the one place that waits
    assert [s.launch for s in sess.samples] == [1, 2, 3, 4] and stub_card.waits == 1
    assert not any(s.profiled for s in sess.samples) and len(stub_card.made) == 6   # the 4th pair reuses events
    events = [e for e in telemetry.read_jsonl(path) if e["event"] == "device_time"]
    assert [(e["site"], e["backend"], e["launch"]) for e in events] == [("segment", "cuda", n) for n in (1, 2, 3, 4)]


def test_a_timed_launch_past_the_pending_bound_goes_untimed(stub_card, monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_PENDING", 2)
    sess = telemetry.enable(device_time_rate=1)
    fn = telemetry.instrument_launch(lambda: None, site="s", backend="cuda")
    for _ in range(4):
        fn()
    assert len(stub_card.made) == 4                              # two pairs, then two untimed launches
    telemetry.disable()
    assert [s.launch for s in sess.samples] == [1, 2]


def test_a_launch_that_leaves_its_output_on_the_host_is_clock_timed_and_its_event_reused(stub_card):
    sess = telemetry.enable(device_time_rate=1)
    fn = telemetry.instrument_launch(lambda: torch.zeros(1), site="s", backend="cuda")
    fn(), fn()
    assert len(stub_card.made) == 1                              # the first start event came back
    assert [s.launch for s in sess.samples] == [1, 2] and all(s.dur_s >= 0 for s in sess.samples)
    telemetry.disable()
    assert stub_card.waits == 0 and not sess._pending[("s", "cuda")]


def test_on_the_host_a_sample_is_the_calls_clock_time():
    sess = telemetry.enable(device_time_rate=2)
    fn = telemetry.instrument_launch(lambda x: x + 1, site="s", backend="basis")
    assert [fn(torch.zeros(1)).item() for _ in range(4)] == [1.0] * 4
    assert [s.launch for s in sess.samples] == [2, 4] and all(s.dur_s >= 0 for s in sess.samples)
