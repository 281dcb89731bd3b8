"""The port's fleet controller (``repro_torch.serving.fleet``) and fleet
report (``repro_torch.serving.observe``) against the reference's, on the
``basis`` backend, on 20x20 frames, the same seeded numpy frames and the
reference's calibration handed over as numpy.

Tolerances, each with its reason:

* water-filling splits, admission and queue order, activities,
  allocations, servo targets and thresholds, the arbitration table, the
  ``fleet_report`` rows and its rendering, error types and messages: equal
  (the same Python and numpy arithmetic on equal gate masks; the masks are
  equal because the gate's effective frames are bit-equal to the
  reference's and its block deltas within a few ulps, far from the
  thresholds here);
* counts: at most 1 ADC count and fewer than 5% off (round-half flips of
  f32 sums taken in another order);
* within the port, bit for bit: fleet segment serving against a plain
  server given the same target.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import counts_close, same_error
from repro.data.pipeline import SyntheticMovingObject as JMoving
from repro.serving import fleet as j_fleet
from repro.serving import fpca_pipeline as jpipe
from repro.serving import observe as j_observe
from repro.serving import streaming as j_streaming
from repro_torch import fpca
from repro_torch.convert import bucket_model_from_dict
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.fpca import telemetry
from repro_torch.serving import fleet, observe, streaming
from repro_torch.serving import fpca_pipeline as ppipe

pytestmark = pytest.mark.fleet

H = W = 20
GATE = dict(threshold=0.05, hysteresis=1, keyframe_interval=8)


def _kernel() -> np.ndarray:
    return (np.random.default_rng(0).normal(size=(4, 5, 5, 3)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


class _Side:
    """One side's modules: the reference's or the port's."""

    def __init__(self, ref: bool, model):
        self.ref = ref
        self.F = jfpca if ref else fpca
        self.P = jpipe if ref else ppipe
        self.S = j_streaming if ref else streaming
        self.fleet = j_fleet if ref else fleet
        self.observe = j_observe if ref else observe
        self.Moving = JMoving if ref else SyntheticMovingObject
        self.model = model

    def pipeline(self):
        kw = {} if self.ref else {"device": "cpu"}
        pipe = self.P.FPCAPipeline(self.model, backend="basis", **kw)
        pipe.register("cam", self.F.FPCASpec(image_h=H, image_w=W, out_channels=4, kernel=5, stride=5), _kernel())
        return pipe

    def fleet_of(self, config, target: float = 0.5, controller: bool = True):
        pipe = self.pipeline()
        ctl = self.S.GateControllerConfig(target=target) if controller else None
        server = self.S.StreamServer(pipe, gate=self.S.DeltaGateConfig(**GATE), controller=ctl)
        return pipe, server, self.fleet.FleetController(server, config)


@pytest.fixture(scope="module")
def sides(bucket_model, port_model):
    return _Side(True, bucket_model), _Side(False, port_model)


def _busy(seed: int = 3) -> SyntheticMovingObject:
    return SyntheticMovingObject((H, W), seed=seed, radius=4.0)


def _static_frame(seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("budget,lo,hi", [(0.6, 0.1, 0.9), (2.4, 0.02, 0.9), (0.35, 0.1, 0.3), (1.0, 0.05, 0.2)])
def test_waterfill_matches_reference(seed, budget, lo, hi):
    rng = np.random.default_rng(seed)
    n = min(int(rng.integers(1, 8)), int(budget / lo + 1e-9))    # admission keeps n * floor <= budget
    weights = {f"s{i}": float(w) for i, w in enumerate(rng.uniform(0.001, 3.0, n))}
    got = fleet._waterfill(weights, budget, lo, hi)
    assert got == j_fleet._waterfill(weights, budget, lo, hi)
    assert sum(got.values()) == pytest.approx(min(budget, n * hi))


def test_fleet_config_validation_matches_reference():
    bad = [dict(budget=0.0), dict(floor=0.0), dict(floor=0.5, ceiling=0.4), dict(budget=0.1, floor=0.2),
           dict(ema_alpha=0.0), dict(rebalance_ticks=0), dict(admission="drop"), dict(activity_floor=0.0)]
    for kw in bad:
        same_error(lambda: j_fleet.FleetConfig(**kw), lambda: fleet.FleetConfig(**kw))
    assert fleet.FleetConfig() == fleet.FleetConfig(**{
        f: getattr(j_fleet.FleetConfig(), f) for f in ("budget", "floor", "ceiling", "ema_alpha",
                                                         "rebalance_ticks", "admission", "activity_floor")})


def test_arbitration_matches_reference(sides):
    """Busy vs static stream: activities, allocations, servo targets and
    thresholds equal the reference's tick for tick; the busy scene wins
    budget and the total stays pinned."""
    cfg_kw = dict(budget=0.6, floor=0.1, ceiling=0.9, rebalance_ticks=4)
    tables = []
    for side in sides:
        pipe, server, fc = side.fleet_of(side.fleet.FleetConfig(**cfg_kw))
        fc.add_stream("busy", "cam")
        fc.add_stream("static", "cam", priority=2.0)
        cam, still = side.Moving((H, W), seed=3, radius=4.0), _static_frame()
        trace = []
        for results in fc.run({"busy": cam.frame_at(t), "static": still} for t in range(16)):
            trace.append([(r.stream_id, r.kept_windows) for r in results])
        tables.append((fc.arbitration_table(), trace, fc.rebalances))
        m_busy, m_static = fc._members["busy"], fc._members["static"]
        assert m_busy.activity > m_static.activity
        assert m_busy.allocation + m_static.allocation == pytest.approx(cfg_kw["budget"])
        for m in (m_busy, m_static):
            assert m.session.controller.config.target == pytest.approx(m.allocation)
    assert tables[1] == tables[0]


def test_segment_serving_rebalances_and_matches_plain_server(sides):
    ref, port = sides
    cfg_kw = dict(budget=0.4, floor=0.1, ceiling=0.4, rebalance_ticks=1000)
    frames = np.stack([_busy(9).frame_at(t) for t in range(12)])
    out = {}
    for side in sides:
        _, _, fc = side.fleet_of(side.fleet.FleetConfig(**cfg_kw))
        fc.add_stream("s0", "cam")
        before = fc.rebalances
        got = list(fc.serve_segments("s0", frames, segment_length=4))
        assert fc.rebalances - before == 3 and fc._members["s0"].ticks_observed == 12
        out[side.ref] = (got, fc.arbitration_table())
    got, want = out[False][0], out[True][0]
    assert out[False][1] == out[True][1]
    for a, b in zip(got, want):
        assert a.frame_idx == b.frame_idx and a.kept_windows == b.kept_windows
        np.testing.assert_array_equal(a.block_mask, b.block_mask)
    counts_close(np.stack([r.counts for r in got]), np.stack([r.counts for r in want]))
    # within the port: one admitted stream at the budget clamp == a plain
    # server with that target, bit for bit
    plain = streaming.StreamServer(port.pipeline(), gate=streaming.DeltaGateConfig(**GATE),
                                   controller=streaming.GateControllerConfig(target=0.4))
    plain.add_stream("s0", "cam")
    for a, b in zip(got, plain.serve_segments("s0", frames, segment_length=4)):
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.block_mask, b.block_mask)


def test_admission_and_queue_match_reference(sides):
    traces = []
    for side in sides:
        F = side.fleet
        pipe, server, fc = side.fleet_of(F.FleetConfig(budget=0.6, floor=0.2))
        for i in range(3):
            assert fc.add_stream(f"s{i}", "cam") is not None
        with pytest.raises(F.FleetAdmissionError) as e:
            fc.add_stream("s3", "cam")
        assert len(server.sessions) == 3
        side.observe.assert_reconciled(pipe, server)
        _, server_q, fq = side.fleet_of(F.FleetConfig(budget=0.6, floor=0.2, admission="queue"))
        for i in range(3):
            fq.add_stream(f"s{i}", "cam")
        assert fq.add_stream("s3", "cam", priority=2.0) is None
        assert fq.add_stream("s4", "cam") is None
        first = [s.stream_id for s in fq.remove_stream("s1")]
        second = [s.stream_id for s in fq.remove_stream("s2")]
        traces.append((str(e.value), fc.capacity, fc.rejections, fq.queued, first, second,
                       fq._members["s3"].priority, sorted(server_q.sessions), fq.arbitration_table()))
    assert traces[1] == traces[0]
    assert traces[1][4:6] == (["s3"], ["s4"])


def test_admission_errors_match_reference(sides):
    ref, port = sides
    fleets = [side.fleet_of(side.fleet.FleetConfig(budget=0.6, floor=0.1)) for side in sides]
    for _, _, fc in fleets:
        fc.add_stream("s0", "cam")
    (_, _, jfc), (_, _, pfc) = fleets
    same_error(lambda: jfc.add_stream("s0", "cam"), lambda: pfc.add_stream("s0", "cam"))
    same_error(lambda: jfc.add_stream("s1", "cam", priority=0.0), lambda: pfc.add_stream("s1", "cam", priority=0.0))
    same_error(lambda: jfc.remove_stream("ghost"), lambda: pfc.remove_stream("ghost"))
    plain = [side.fleet_of(side.fleet.FleetConfig(budget=0.6, floor=0.1), controller=False) for side in sides]
    same_error(lambda: plain[0][2].add_stream("s0", "cam"), lambda: plain[1][2].add_stream("s0", "cam"))
    assert "s0" not in plain[1][1].sessions     # rolled back
    full = [side.fleet_of(side.fleet.FleetConfig(budget=0.2, floor=0.1)) for side in sides]
    for _, _, fc in full:
        fc.add_stream("a", "cam")
        fc.add_stream("b", "cam")
    same_error(lambda: full[0][2].add_stream("c", "cam"), lambda: full[1][2].add_stream("c", "cam"))
    assert issubclass(fleet.FleetAdmissionError, RuntimeError)


@pytest.mark.telemetry
def test_allocation_gauges_sum_to_budget_and_zero_on_removal(sides):
    _, port = sides
    cfg = fleet.FleetConfig(budget=0.6, floor=0.1)
    _, _, fc = port.fleet_of(cfg)
    fc.add_stream("pg0", "cam")
    fc.add_stream("pg1", "cam", priority=3.0)

    def rows():
        return {labels["stream"]: value for name, _k, labels, value in telemetry.registry().collect()
                if name == "fpca_fleet_allocation" and labels.get("stream") in ("pg0", "pg1")}

    assert sum(rows().values()) == pytest.approx(cfg.budget)
    assert rows()["pg1"] > rows()["pg0"]
    budget = [v for n, _k, _l, v in telemetry.registry().collect() if n == "fpca_fleet_budget"]
    assert budget == [pytest.approx(cfg.budget)]
    fc.remove_stream("pg0")
    assert rows()["pg0"] == 0.0 and rows()["pg1"] == pytest.approx(cfg.budget)


def _workloads_delta(observe_mod, before: dict) -> dict:
    """The per-arch workload rows this test added (the registry is
    process-wide, so other tests' rows are subtracted)."""
    after = observe_mod._workload_rows()
    out = {}
    for arch, row in after.items():
        for k, v in row.items():
            d = v - before.get(arch, {}).get(k, 0)
            if d:
                out.setdefault(arch, {})[k] = d
    return out


@pytest.mark.telemetry
def test_fleet_report_matches_reference(sides):
    reports = []
    for side in sides:
        before = side.observe._workload_rows()
        pipe, server, fc = side.fleet_of(side.fleet.FleetConfig(budget=0.6, floor=0.1), target=0.3)
        fc.add_stream("busy", "cam", events=True)
        fc.add_stream("idle", "cam")
        server.add_stream("fan", ("cam",), gate=None)
        cam, still = side.Moving((H, W), seed=5, radius=4.0), _static_frame(11)
        for _ in fc.run({"busy": cam.frame_at(t), "idle": still, "fan": still} for t in range(10)):
            pass
        list(fc.serve_segments("busy", [cam.frame_at(t) for t in range(10, 18)], segment_length=4))
        side.observe.assert_reconciled(pipe, server)
        rep = side.observe.fleet_report(server, fleet=fc)
        json.dumps(rep, allow_nan=False)        # strict JSON
        for key in ("serve_seconds", "fps_wall"):
            rep["fleet"].pop(key)
        rep.pop("workloads")    # process-wide: compared below as this test's delta
        reports.append((rep, _workloads_delta(side.observe, before)))
    (want, want_w), (got, got_w) = reports
    assert got == want
    assert got_w == want_w and got_w["events"]["fpca_events_events"] > 0
    # the renderer: the same text from the same report
    full = observe.fleet_report(sides[1].fleet_of(fleet.FleetConfig())[1])
    assert observe.render_fleet_report(got | {"fleet": {**got["fleet"], "fps_wall": 1.5, "serve_seconds": 2.0}}) == \
        j_observe.render_fleet_report(got | {"fleet": {**got["fleet"], "fps_wall": 1.5, "serve_seconds": 2.0}})
    assert full["streams"] == []


@pytest.mark.telemetry
def test_assert_reconciled_catches_what_the_reference_catches(sides):
    msgs = []
    for side in sides:
        pipe, server, fc = side.fleet_of(side.fleet.FleetConfig(budget=0.6, floor=0.1))
        fc.add_stream("ev", "cam", events=True)
        cam = side.Moving((H, W), seed=6, radius=4.0)
        list(fc.serve("ev", (cam.frame_at(t) for t in range(5))))
        side.observe.assert_reconciled(pipe, server)
        server.event_taps["ev"].stats.events += 1
        with pytest.raises(AssertionError) as e:
            side.observe.assert_reconciled(pipe, server)
        msgs.append(str(e.value).split("\n")[0])
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# data-parallel serving (mesh=): a world-1 gloo mesh in this process, and two
# gloo ranks in subprocesses
# ---------------------------------------------------------------------------


def _sharded_fleet(side, mesh):
    pipe = side.P.FPCAPipeline(side.model, backend="basis", device="cpu", mesh=mesh)
    pipe.register("cam", side.F.FPCASpec(image_h=H, image_w=W, out_channels=4, kernel=5, stride=5), _kernel())
    server = side.S.StreamServer(pipe, gate=side.S.DeltaGateConfig(**GATE),
                                 controller=side.S.GateControllerConfig(target=0.5))
    return pipe, server, side.fleet.FleetController(server, side.fleet.FleetConfig(budget=0.6, floor=0.1,
                                                                                    rebalance_ticks=4))


def test_sharded_fleet_serving_matches_unsharded(sides):
    """The fused union-masked fleet batch on a one-rank mesh equals the
    unsharded fleet bit for bit, with gate and arbitration state per
    stream; and both match the reference's within the counts tolerance."""
    from repro_torch.launch.mesh import make_host_mesh

    ref, port = sides
    mesh = make_host_mesh(device="cpu")
    cams = {f"cam{i}": _busy(seed=10 + i) for i in range(3)}
    runs = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        pipe, server, fc = _sharded_fleet(port, m)
        for sid in cams:
            fc.add_stream(sid, "cam")
        out = [r for rs in fc.run({sid: c.frame_at(t) for sid, c in cams.items()} for t in range(10)) for r in rs]
        runs[label] = (pipe, server, fc, out)
    pipe_m, server_m, fc_m, got = runs["mesh"]
    _, _, fc_p, want = runs["plain"]
    assert len(got) == len(want) == 30
    for a, b in zip(got, want):
        assert (a.stream_id, a.frame_idx, a.kept_windows) == (b.stream_id, b.frame_idx, b.kept_windows)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.block_mask, b.block_mask)
    for sid in cams:
        assert fc_m._members[sid].allocation == fc_p._members[sid].allocation
    handles = list(pipe_m._handles.values())
    assert handles and all(h.data_parallelism == 1 and h.mesh is mesh for h in handles)
    for session in server_m.sessions.values():
        assert type(session._prev) is torch.Tensor      # per stream on this rank, never sharded
    observe.assert_reconciled(pipe_m, server_m)
    _, _, j_fc = ref.fleet_of(ref.fleet.FleetConfig(budget=0.6, floor=0.1, rebalance_ticks=4))
    j_cams = {f"cam{i}": JMoving((H, W), seed=10 + i, radius=4.0) for i in range(3)}
    for sid in j_cams:
        j_fc.add_stream(sid, "cam")
    j_out = [r for rs in j_fc.run({sid: c.frame_at(t) for sid, c in j_cams.items()} for t in range(10)) for r in rs]
    for a, b in zip(got, j_out):
        assert a.kept_windows == b.kept_windows
    counts_close(np.stack([r.counts for r in got]), np.stack([r.counts for r in j_out]))


def test_data_parallelism_property_unsharded(sides):
    _, port = sides
    pipe, server, fc = port.fleet_of(port.fleet.FleetConfig(budget=0.6, floor=0.1))
    fc.add_stream("s0", "cam")
    cam = _busy(seed=11)
    list(fc.serve("s0", (cam.frame_at(t) for t in range(2))))
    handles = list(pipe._handles.values())
    assert handles and all(h.data_parallelism == 1 and h.mesh is None for h in handles)


_TWO_RANKS = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, store_path, src = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, src)
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
from repro_torch import fpca
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import fleet, streaming
from repro_torch.serving import fpca_pipeline as ppipe

model = fit_bucket_model(device="cpu")
kern = (np.random.default_rng(0).normal(size=(4, 5, 5, 3)) * 0.2).astype(np.float32)
spec = fpca.FPCASpec(image_h=20, image_w=20, out_channels=4, kernel=5, stride=5)
mesh = make_host_mesh(data=2, device="cpu")

def serve(m):
    pipe = ppipe.FPCAPipeline(model, backend="basis", device="cpu", mesh=m)
    pipe.register("cam", spec, kern)
    server = streaming.StreamServer(pipe, gate=streaming.DeltaGateConfig(threshold=0.05, hysteresis=1, keyframe_interval=8),
                                    controller=streaming.GateControllerConfig(target=0.5))
    fc = fleet.FleetController(server, fleet.FleetConfig(budget=0.6, floor=0.1, rebalance_ticks=4))
    cams = {f"cam{i}": SyntheticMovingObject((20, 20), seed=10 + i, radius=4.0) for i in range(3)}
    for sid in cams:
        fc.add_stream(sid, "cam")
    out = [r for rs in fc.run({sid: c.frame_at(t) for sid, c in cams.items()} for t in range(10)) for r in rs]
    return pipe, fc, out

pipe_m, fc_m, got = serve(mesh)
_, fc_p, want = serve(None)
same = all(a.kept_windows == b.kept_windows and np.array_equal(a.counts, b.counts)
           and np.array_equal(a.block_mask, b.block_mask) for a, b in zip(got, want))
alloc = all(fc_m._members[s].allocation == fc_p._members[s].allocation for s in fc_m._members)
# a model handle: an odd batch pads to 4 and splits 2 + 2, a block mask skips regions
prog = fpca.build_model({"arch": "fpca_cnn"})
head = prog.init_head(torch.Generator().manual_seed(0), device="cpu")
kern_m = (np.random.default_rng(3).normal(size=prog.frontend.kernel_shape) * 0.2).astype(np.float32)
sp = prog.spec
frames = torch.rand((3, sp.image_h, sp.image_w, 3), generator=torch.Generator().manual_seed(1))
mask = np.random.default_rng(2).random((3, -(-sp.eff_h // sp.skip_block), -(-sp.eff_w // sp.skip_block))) < 0.5
logits = []
for m in (mesh, None):
    h = fpca.compile(prog, device="cpu", mesh=m, weights=kern_m, head_params=head, model=model, backend="basis")
    logits.append((h.run(frames), h.run(frames, block_mask=mask), h.data_parallelism))
model_same = torch.equal(logits[0][0], logits[1][0]) and torch.equal(logits[0][1], logits[1][1])
print(json.dumps({"rank": rank, "n": len(got), "same": same, "alloc": alloc, "model_same": model_same,
                  "dp": [h.data_parallelism for h in pipe_m._handles.values()] + [logits[0][2]]}))
dist.destroy_process_group()
'''


def test_two_gloo_ranks_fleet_equals_unsharded(tmp_path):
    """A data=2 fleet over two gloo ranks on the host: every rank runs the
    gate and arbitration, launches its half of each fused batch and gathers
    the counts; the results equal the unsharded fleet's bit for bit on both
    ranks (and a model handle's logits, with and without a block mask)."""
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), store, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rec in outs:
        assert rec["n"] == 30 and rec["same"] and rec["alloc"] and rec["model_same"]
        assert rec["dp"] and all(d == 2 for d in rec["dp"])
