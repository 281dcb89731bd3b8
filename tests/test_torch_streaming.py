"""The port's streaming modules against the reference on the same numpy
inputs: ``core/gating``, ``StreamSession.step`` / ``absorb_segment`` /
``energy_report``, the ``GateController`` servo, ``core/analysis``, the
telemetry registry and ``StatsView``, the moving-object video and
``segment_bucket``; and the import graph of the port.

Tolerances, each with its reason:

* effective frames, window masks, block keep masks, keyframes, ages and
  frame indices: equal (the port sums the channel and binning means in the
  reference's order and multiplies by the same float32 reciprocal);
* block deltas: within 8 float32 ulps of the reference's own value.  A
  block's mean sums up to 64 pixels; XLA adds them one by one in row-major
  order, torch in another order, and the sums differ by a few roundings
  (at most 5 ulps measured over these inputs).  The keep decisions compare
  the delta with the threshold, so a mask could differ only for a delta
  within those few ulps of the threshold: the masks here are equal;
* energies, latencies, head FLOPs, controller thresholds and the telemetry
  exports: equal (the same numpy and Python arithmetic on the same inputs).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as j_analysis
from repro.core import gating as j_gating
from repro.core import mapping as j_mapping
from repro.data import pipeline as j_pipeline
from repro.fpca import telemetry as j_tel
from repro.fpca import zoo as j_zoo
from repro.kernels.fpca_conv import ops as j_ops
from repro.serving import control as j_control
from repro.serving import streaming as j_streaming
from repro_torch.core import analysis, gating, mapping
from repro_torch.data import pipeline
from repro_torch.fpca import program, telemetry, zoo
from repro_torch.kernels.fpca_conv import ops
from repro_torch.serving import control, streaming

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DELTA_ULPS = 8

SPECS = [
    dict(image_h=20, image_w=20, out_channels=3, kernel=5, stride=5),
    dict(image_h=23, image_w=19, out_channels=3, kernel=3, stride=2, binning=2, skip_block=4),
    dict(image_h=120, image_w=120, out_channels=8, kernel=5, stride=5),
]


def _specs(kw: dict) -> tuple[mapping.FPCASpec, j_mapping.FPCASpec]:
    return mapping.FPCASpec(**kw), j_mapping.FPCASpec(**kw)


def _frames(kw: dict, n: int, seed: int) -> np.ndarray:
    """Random frames with a repeated pair (zero deltas) and a small change."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 1, (n, kw["image_h"], kw["image_w"], 3)).astype(np.float32)
    f[2] = f[1]
    f[3] = f[2]
    f[3, :6, :6] = np.clip(f[3, :6, :6] + 0.3, 0, 1)
    return f


def _assert_ulps(got: np.ndarray, want: np.ndarray, ulps: int = DELTA_ULPS) -> None:
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want)))


# ---------------------------------------------------------------------------
# core/gating
# ---------------------------------------------------------------------------


@pytest.mark.segment
@pytest.mark.parametrize("kw", SPECS)
def test_gate_numerics_match_reference(kw):
    spec, jspec = _specs(kw)
    frames = _frames(kw, 4, seed=len(kw))
    assert gating.block_grid(spec) == j_gating.block_grid(jspec)
    effs = [gating.effective_frame(torch.from_numpy(f), spec).numpy() for f in frames]
    for f, e in zip(frames, effs):
        np.testing.assert_array_equal(e, np.asarray(j_gating.effective_frame(jnp.asarray(f), jspec)))
    batched = gating.effective_frame(torch.from_numpy(frames), spec).numpy()
    np.testing.assert_array_equal(batched, np.stack(effs))
    for a, b in zip(effs[:-1], effs[1:]):
        got = gating.block_delta(torch.from_numpy(a), torch.from_numpy(b), spec).numpy()
        want = np.asarray(j_gating.block_delta(jnp.asarray(a), jnp.asarray(b), jspec))
        _assert_ulps(got, want)
    rng = np.random.default_rng(3)
    for p in (0.0, 0.2, 1.0):
        blocks = rng.random(gating.block_grid(spec)) < p
        got = gating.window_mask_from_blocks(torch.from_numpy(blocks), spec).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_gating.window_mask_from_blocks(jnp.asarray(blocks), jspec)))
        np.testing.assert_array_equal(got, mapping.active_window_mask(spec, blocks))


@pytest.mark.segment
@pytest.mark.parametrize("threshold,hysteresis,interval", [(0.02, 1, 3), (0.001, 0, 0), (0.2, 2, 1)])
def test_gate_tick_state_machine_matches_reference(threshold, hysteresis, interval):
    kw = SPECS[0]
    spec, jspec = _specs(kw)
    frames = _frames(kw, 7, seed=11)
    frames[5] = frames[4]
    carry = gating.init_gate_carry(spec, hysteresis, CPU)
    jcarry = j_gating.init_gate_carry(jspec, hysteresis)
    knobs = (torch.tensor(threshold, dtype=torch.float32), torch.tensor(hysteresis, dtype=torch.int32),
             torch.tensor(interval, dtype=torch.int32))
    jknobs = (jnp.float32(threshold), jnp.int32(hysteresis), jnp.int32(interval))
    for f in frames:
        carry, keep, kf = gating.gate_tick(spec, carry, gating.effective_frame(torch.from_numpy(f), spec), *knobs)
        jcarry, jkeep, jkf = j_gating.gate_tick(jspec, jcarry, j_gating.effective_frame(jnp.asarray(f), jspec),
                                                *jknobs)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        assert bool(kf) == bool(jkf)
        for a, b in zip(carry, jcarry):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.segment
def test_host_gate_kernels_batch_equals_solo_bitwise():
    kw = SPECS[2]
    spec, _ = _specs(kw)
    frames = _frames(kw, 4, seed=5)
    k = gating.host_gate_kernels(spec, CPU)
    prev = np.stack([k.eff(f).numpy() for f in frames[::-1]])
    cur_b, delta_b = k.step_batch(prev, frames)
    for i, f in enumerate(frames):
        cur, delta = k.step(prev[i], f)
        assert torch.equal(cur_b[i], cur) and torch.equal(delta_b[i], delta)
        assert torch.equal(k.delta(prev[i], cur), delta)


# ---------------------------------------------------------------------------
# StreamSession and GateController
# ---------------------------------------------------------------------------


def _sessions(gate_kw: dict, controller: dict | None = None, kw: dict = SPECS[0]):
    spec, jspec = _specs(kw)
    gate, jgate = program.DeltaGateConfig(**gate_kw), j_streaming.DeltaGateConfig(**gate_kw)
    ctl = jctl = None
    if controller is not None:
        ctl = control.GateController(program.GateControllerConfig(**controller), spec, gate.threshold, name="p")
        jctl = j_control.GateController(j_streaming.GateControllerConfig(**controller), jspec, jgate.threshold,
                                        name="j")
    return (streaming.StreamSession("s", "cfg", spec, gate, controller=ctl, device="cpu"),
            j_streaming.StreamSession("s", "cfg", jspec, jgate, controller=jctl))


def _assert_sessions_equal(s, js) -> None:
    assert s.frame_idx == js.frame_idx
    np.testing.assert_array_equal(s.last_window_mask, js.last_window_mask)
    st, jst = s._primary, js._primary
    np.testing.assert_array_equal(st.age, jst.age)
    assert st.last_keyframe == jst.last_keyframe and st.changed_total == jst.changed_total
    assert st.gate.threshold == jst.gate.threshold


@pytest.mark.segment
@pytest.mark.parametrize("gate_kw", [dict(threshold=0.02, hysteresis=1, keyframe_interval=3),
                                     dict(threshold=0.05, hysteresis=0, keyframe_interval=0)])
def test_session_steps_like_reference(gate_kw):
    s, js = _sessions(gate_kw)
    for f in _frames(SPECS[0], 8, seed=21):
        np.testing.assert_array_equal(s.step(f), js.step(f))
        _assert_sessions_equal(s, js)
    np.testing.assert_array_equal(s.prev_eff, js._prev)
    assert s.energy_report() == js.energy_report()
    f0, _, _, f1 = _frames(SPECS[0], 4, seed=24)
    e0, e1 = streaming._effective_frame(f0, s.spec, "cpu"), streaming._effective_frame(f1, s.spec, "cpu")
    np.testing.assert_array_equal(e0, j_streaming._effective_frame(f0, js.spec))
    _assert_ulps(streaming.block_delta(e0, e1, s.spec, "cpu"), j_streaming.block_delta(e0, e1, js.spec))
    np.testing.assert_array_equal(streaming.block_delta_mask(e0, e1, s.spec, 0.3, "cpu"),
                                  j_streaming.block_delta_mask(e0, e1, js.spec, 0.3))


@pytest.mark.segment
def test_session_per_config_gates_and_dense_like_reference():
    kw = SPECS[0]
    spec, jspec = _specs(kw)
    gates = {"a": dict(threshold=0.02, hysteresis=1, keyframe_interval=4),
             "b": dict(threshold=0.3, hysteresis=0, keyframe_interval=0)}
    s = streaming.StreamSession("s", ("a", "b"), spec, {k: program.DeltaGateConfig(**v) for k, v in gates.items()},
                                device="cpu")
    js = j_streaming.StreamSession("s", ("a", "b"), jspec,
                                   {k: j_streaming.DeltaGateConfig(**v) for k, v in gates.items()})
    dense = streaming.StreamSession("d", "cfg", spec, None, device="cpu")
    for f in _frames(kw, 6, seed=22):
        np.testing.assert_array_equal(s.step(f), js.step(f))
        np.testing.assert_array_equal(s.last_window_mask, js.last_window_mask)
        for name in ("a", "b"):
            np.testing.assert_array_equal(s.state_for(name).last_block_mask, js.state_for(name).last_block_mask)
        assert dense.step(f) is None
    assert dense.frame_idx == 6 and not dense.block_masks
    assert s.energy_report(config="b") == js.energy_report(config="b")
    with pytest.raises(KeyError):
        s.energy_report(config="c")


@pytest.mark.segment
@pytest.mark.parametrize("metric", ["keep", "energy"])
def test_controller_trajectory_matches_reference(metric):
    """The servo on the same gate masks: thresholds, EMA and history equal,
    per tick and at segment boundaries; retarget carries over."""
    cfg = dict(target=0.3, metric=metric, deadband=0.01, history_len=64)
    s, js = _sessions(dict(threshold=0.02, hysteresis=1, keyframe_interval=5), controller=cfg)
    for f in _frames(SPECS[0], 10, seed=23):
        s.step(f)
        js.step(f)
        _assert_sessions_equal(s, js)
    ctl, jctl = s.controller, js.controller
    rng = np.random.default_rng(4)
    masks = [rng.random(gating.block_grid(s.spec)) < p for p in (0.1, 0.5, 0.9, 0.0)]
    kfs = [False, True, False, False]
    assert ctl.observe_segment(masks, keyframes=kfs) == jctl.observe_segment(masks, keyframes=kfs)
    assert ctl.observe_segment([]) == jctl.observe_segment([])
    ctl.retarget(0.2)
    jctl.retarget(0.2)
    assert ctl.observe(masks[1]) == jctl.observe(masks[1])
    assert list(ctl.history) == list(jctl.history) and ctl.ema == jctl.ema
    assert ctl.converged_tick() == jctl.converged_tick()


# ---------------------------------------------------------------------------
# core/analysis
# ---------------------------------------------------------------------------


@pytest.mark.telemetry
@pytest.mark.parametrize("kw", SPECS + [dict(image_h=32, image_w=30, out_channels=4, kernel=3, stride=2)])
def test_frontend_models_match_reference(kw):
    spec, jspec = _specs(kw)
    assert mapping.n_cycles(spec) == j_mapping.n_cycles(jspec)
    rng = np.random.default_rng(6)
    masks = [rng.random(gating.block_grid(spec)) < p for p in (0.0, 0.3, 1.0)] + [None]
    for m in masks:
        assert mapping.n_cycles_with_skipping(spec, m) == j_mapping.n_cycles_with_skipping(jspec, m)
        assert analysis.frontend_energy(spec, block_mask=m) == j_analysis.frontend_energy(jspec, block_mask=m)
        assert analysis.frontend_latency(spec, block_mask=m) == j_analysis.frontend_latency(jspec, block_mask=m)
    assert analysis.streaming_frontend_report(spec, masks) == j_analysis.streaming_frontend_report(jspec, masks)
    assert analysis.bandwidth_reduction(spec) == j_analysis.bandwidth_reduction(jspec)
    assert analysis.conventional_cis(spec.image_h, spec.image_w) == j_analysis.conventional_cis(
        jspec.image_h, jspec.image_w)
    with pytest.raises(ValueError, match="empty mask history"):
        analysis.streaming_frontend_report(spec, [])


@pytest.mark.telemetry
@pytest.mark.parametrize("cfg", [{"arch": "fpca_cnn"}, {"arch": "fpca_resnet"}, {"arch": "fpca_detect"},
                                 {"arch": "fpca_cnn", "precision": "int8"}])
def test_head_costs_match_reference(cfg):
    """The graph-aware head FLOP and energy reports on the zoo's archs."""
    m, jm = zoo.build_model(cfg), j_zoo.build_model(cfg)
    assert analysis.head_flops(m) == j_analysis.head_flops(jm)
    assert analysis.head_report(m) == j_analysis.head_report(jm)
    rng = np.random.default_rng(7)
    masks = [rng.random(gating.block_grid(m.spec)) < 0.4 for _ in range(3)]
    assert analysis.model_streaming_report(m, masks) == j_analysis.model_streaming_report(jm, masks)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("x_total", "a counter", ("site",), max_label_sets=2)
    for site in ("a", "b", "c", "d"):
        c.labels(site=site).add(2)
    reg.gauge("g", "a gauge").cell().set(1.5)
    h = reg.histogram("lat_seconds", "a histogram", ("op",))
    for v in (2e-5, 5e-3, 0.7, 20.0):
        h.labels(op="run").observe(v)
    reg.gauge("nothing").cell().set(None)
    return reg


@pytest.mark.telemetry
def test_registry_exports_match_reference():
    reg, jreg = _drive_registry(telemetry), _drive_registry(j_tel)
    assert reg.render() == jreg.render()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.collect() == jreg.collect()
    reg.reset()
    jreg.reset()
    assert reg.render() == jreg.render()
    assert telemetry.jsonable({"a": [float("inf"), np.float32(2.5)]}) == j_tel.jsonable(
        {"a": [float("inf"), np.float32(2.5)]})


class _PortParent(telemetry.StatsView):
    _PREFIX = "t_parent"
    _FIELDS = ("batches", "windows_executed")


class _PortChild(telemetry.StatsView):
    _PREFIX = "t_child"
    _FIELDS = ("runs", "windows_executed", "reprograms")
    _PARENT_MAP = {"runs": "batches", "reprograms": None}


class _RefParent(j_tel.StatsView):
    _PREFIX = "t_parent"
    _FIELDS = ("batches", "windows_executed")


class _RefChild(j_tel.StatsView):
    _PREFIX = "t_child"
    _FIELDS = ("runs", "windows_executed", "reprograms")
    _PARENT_MAP = {"runs": "batches", "reprograms": None}


@pytest.mark.telemetry
def test_stats_views_chain_like_reference():
    results = []
    for parent_cls, child_cls in ((_PortParent, _PortChild), (_RefParent, _RefChild)):
        parent = parent_cls()
        a, b = child_cls(parent=parent), child_cls(parent=parent)
        a.runs += 2
        b.runs += 1
        a.windows_executed += 10
        b.reprograms += 3
        with pytest.raises(AttributeError):
            a.nope += 1
        results.append((parent.snapshot(), a.snapshot(), b.as_dict(), repr(b).split("(")[1]))
        assert a != b and a == a
    assert results[0] == results[1]
    from repro_torch.fpca.executable import FrontendStats
    from repro.fpca.executable import FrontendStats as JFrontendStats

    assert FrontendStats._FIELDS == JFrontendStats._FIELDS and FrontendStats._PREFIX == JFrontendStats._PREFIX
    assert FrontendStats._PARENT_MAP == JFrontendStats._PARENT_MAP


def _session_events(mod, path: Path) -> list:
    sess = mod.enable(path, device_time_rate=2, run_labels={"run": "t"})
    try:
        with mod.span("outer", {"k": 1}):
            with mod.span("inner"):
                mod.event("note", value=float("nan"), n=3)
        fn = mod.instrument_launch(lambda x: x * 2, site="s", backend="b")
        assert [fn(np.ones(2))[0] for _ in range(3)] == [2.0] * 3
        assert fn.__wrapped__(1) == 2
    finally:
        mod.disable()
    assert not mod.enabled() and mod.span("x") is mod.span("y")
    assert sess.events_written == len(mod.read_jsonl(path))
    return [(e["event"], e.get("span"), e.get("parent"), e.get("depth"), e.get("value"), e.get("launch"))
            for e in mod.read_jsonl(path)]


@pytest.mark.telemetry
def test_session_spans_events_and_launch_hooks_match_reference(tmp_path):
    """The JSONL event stream of one session (timestamps and durations
    aside) and the sampled device-time launches: on the host the sample is
    a synchronous call's clock time."""
    assert _session_events(telemetry, tmp_path / "p.jsonl") == _session_events(j_tel, tmp_path / "j.jsonl")


# ---------------------------------------------------------------------------
# data, buckets and the import graph
# ---------------------------------------------------------------------------


@pytest.mark.segment
def test_moving_object_frames_and_segment_bucket_match_reference():
    got = pipeline.SyntheticMovingObject((48, 40), seed=3, speed=0.3)
    want = j_pipeline.SyntheticMovingObject((48, 40), seed=3, speed=0.3)
    for t in (0, 1, 17):
        np.testing.assert_array_equal(got.frame_at(t), want.frame_at(t))
    np.testing.assert_array_equal(np.stack(list(got.frames(3, start=5))), np.stack(list(want.frames(3, start=5))))
    rng = np.random.default_rng(8)
    for _ in range(20):
        kept = rng.integers(0, 600, size=rng.integers(0, 8))
        kf = rng.random(kept.size) < 0.3
        assert ops.segment_bucket(kept, 576, kf) == j_ops.segment_bucket(kept, 576, kf)
        assert ops.segment_bucket(kept, 576) == j_ops.segment_bucket(kept, 576)


@pytest.mark.segment
def test_compact_rows_matches_nonzero():
    rng = np.random.default_rng(9)
    for m, p in ((1, 1.0), (7, 0.0), (576, 0.1), (576, 1.0)):
        keep = torch.from_numpy(rng.random(m) < p)
        idx, n = ops.compact_rows(keep)
        want = torch.nonzero(keep)[:, 0]
        assert n.dtype == torch.int32 and int(n) == want.numel()
        assert torch.equal(idx[: want.numel()], want) and not bool(idx[want.numel():].any())


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """Every module of ``repro_torch`` (the serving modules among them),
    ``chip_smoke.py`` and the examples it runs (every
    ``examples/*_torch.py``), imported in a fresh interpreter, leave
    neither ``jax`` nor ``repro`` in sys.modules."""
    serving = [f"repro_torch.serving.{m}" for m in
               ("fpca_pipeline", "streaming", "events", "saliency", "fleet", "observe")]
    code = (
        "import importlib, pathlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "twins = sorted(pathlib.Path('examples').glob('*_torch.py'))\n"
        "assert len(twins) == 8, twins\n"
        "for path in twins:\n"
        "    chip_smoke.load_example(path.stem)\n"
        f"missing = sorted(set({serving!r}) - set(sys.modules))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(missing + bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []
