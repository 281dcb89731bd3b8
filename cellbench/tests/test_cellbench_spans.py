"""The program's spans in the benchmark: ``spans.attribute`` and the two
span readers on a synthetic trace, and ``spans.program_session`` against
the program's telemetry and against one without the span ring."""

from __future__ import annotations

import types

import pytest

from cellbench import layout, spans
from cellbench.timing import CALL, WINDOW


class _Ev:
    def __init__(self, name, start, dur, *, cuda=False, corr=0):
        self._v = (name, start, dur, corr)
        self._dev = "DeviceType.CUDA" if cuda else "DeviceType.CPU"

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._dev

    def is_hidden_event(self):
        return False


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def _call(t0: int, corr: int) -> list:
    """One call: run > encode, extract, kernel, each launching one op that
    runs on the device later; the extract range's device copy
    (``gpu_user_annotation``-style, named like the range) is no op."""
    return [
        _Ev(CALL, t0, 100), _Ev("fpca.run", t0 + 1, 90),
        _Ev("fpca.encode", t0 + 2, 8), _Ev("cudaLaunchKernel", t0 + 3, 2, corr=corr),
        _Ev("fpca.extract", t0 + 10, 20), _Ev("aten::contiguous", t0 + 11, 15),
        _Ev("cudaLaunchKernel", t0 + 12, 2, corr=corr + 1),
        _Ev("fpca.kernel", t0 + 30, 20), _Ev("cudaLaunchKernel", t0 + 31, 2, corr=corr + 2),
        _Ev("encode_op", t0 + 400, 5, cuda=True, corr=corr),
        _Ev("elementwise_kernel", t0 + 405, 30, cuda=True, corr=corr + 1),
        _Ev("fpca.extract", t0 + 405, 30, cuda=True),
        _Ev("fpca_tc_kernel", t0 + 435, 50, cuda=True, corr=corr + 2),
    ]


def _trace():
    events = [_Ev(WINDOW, 0, 10_000)] + _call(100, 1) + _call(1_000, 10)
    events += [_Ev("cudaMemcpyAsync", 2_000, 3, corr=50), _Ev("Memcpy DtoH", 2_010, 7, cuda=True, corr=50),
               _Ev("late_op", 20_000, 9, cuda=True, corr=60)]      # after the window
    return _profile(events)


def test_attribute_puts_each_op_under_the_innermost_range_of_its_launch():
    att = spans.attribute(_trace())
    assert att == {"device_ns": {"fpca.encode": 10, "fpca.extract": 60, "fpca.kernel": 100, None: 7}, "calls": 2}


def test_the_span_readers_read_ctx_spans_and_nothing_without():
    rec = types.SimpleNamespace
    records = [rec(name="segment.wait", id=2, parent=1, t0_ns=10, t1_ns=4_000_010, profiled=False),
               rec(name="run_segment", id=1, parent=None, t0_ns=0, t1_ns=5_000_000, profiled=False),
               rec(name="run_segment", id=3, parent=None, t0_ns=0, t1_ns=3_000_000, profiled=False),
               rec(name="run_segment", id=4, parent=None, t0_ns=0, t1_ns=90_000_000, profiled=True)]
    ctx = rec(spans={"records": records, "dropped": 0, "attributed": spans.attribute(_trace())})
    read = {name: layout.metric_reader(name) for name in ("extract_device_ms.batch", "segment_host_ms.stream")}
    assert read["extract_device_ms.batch"](ctx) == pytest.approx(30e-6)
    assert read["segment_host_ms.stream"](ctx) == pytest.approx(2.0)       # (1 + 3) / 2 ms
    parent = rec(window={})                                                 # a program without span records
    assert all(r(parent) is None for r in read.values())


def test_program_session_turns_nothing_on_without_the_span_ring(monkeypatch):
    import repro_torch.fpca

    calls = []
    old = types.SimpleNamespace(enable=lambda **kw: calls.append(kw), disable=lambda: calls.append("off"))
    monkeypatch.setattr(repro_torch.fpca, "telemetry", old)
    ctx = types.SimpleNamespace(window={})
    with spans.program_session(ctx):
        pass
    assert not calls and not hasattr(ctx, "spans")


def test_program_session_keeps_the_programs_records():
    from repro_torch.fpca import telemetry

    ctx = types.SimpleNamespace(window={})
    with spans.program_session(ctx):
        assert telemetry.session().device_time_rate == 0 and telemetry.session().jsonl_path is None
        with telemetry.span("run"):
            pass
    assert not telemetry.enabled()
    assert [r.name for r in ctx.spans["records"]] == ["run"] and ctx.spans["attributed"] is None

