"""The port's stream server (``StreamServer`` in
``repro_torch.serving.streaming``), its event taps (``serving/events.py``)
and ``saliency_mask`` against the reference's, on the ``basis`` backend, on
20x20 frames (a 4x4 window grid, 3x3 skip blocks), the same seeded numpy
frames and the reference's calibration and head parameters handed over as
numpy.

Tolerances, each with its reason:

* block masks, kept windows, frame indices, event packets (coordinates and
  polarity), the server's stats and saliency masks: equal (the gate's
  effective frames are bit-equal to the reference's and its block deltas
  within a few ulps, far from the threshold on these scenes; the signed
  block means of the events are the reference's numpy arithmetic on those
  frames);
* counts: at most 1 ADC count and fewer than 5% off (round-half flips of
  f32 sums taken in another order);
* logits: within 1e-5 of the largest logit of the reference's head applied
  to the port's own effective activation maps (rebuilt on the host from
  the port's counts and masks), so any distance from the reference's
  logits is what the count flips carry through the head;
* within the port, bit for bit: every server camera against its own
  handle's ``stream()``, depth 1 against depth 2, a fan-out's per-config
  results against each config served alone, fused shared heads against
  per-config heads, server segments against server ticks, two streams
  interleaving segments on one handle against each served alone, and the
  taps' event counts against the gate's changed-block counts.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import counts_close, same_error
from repro.serving import events as j_events
from repro.serving import fpca_pipeline as jpipe
from repro.serving import saliency as j_saliency
from repro.serving import streaming as j_streaming
from repro_torch import fpca
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy
from repro_torch.core.mapping import active_window_mask
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.serving import events, saliency, streaming
from repro_torch.serving import fpca_pipeline as ppipe

H = W = 20
C_O = 3
TICKS = 8
GATE = dict(threshold=0.02, hysteresis=1, keyframe_interval=4)


def _spec(mod):
    return mod.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=5)


def _kernel(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(C_O, 5, 5, 3)) * 0.2).astype(np.float32)


def _numpy_head(params):
    if isinstance(params, dict):
        return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _model_progs(mod):
    build = jfpca.build_model if mod is jfpca else fpca.build_model
    fe = mod.FPCAProgram(spec=_spec(mod))
    return {
        "cnn": build({"arch": "fpca_cnn", "frontend": fe, "hidden": 8, "n_classes": 3}),
        "det": build({"arch": "fpca_detect", "frontend": fe, "width": 4, "n_classes": 2}),
    }


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


@pytest.fixture(scope="module")
def heads():
    progs = _model_progs(jfpca)
    out = {n: _numpy_head(m.init_head(jax.random.PRNGKey(i + 1))) for i, (n, m) in enumerate(progs.items())}
    out["cnn_b"] = _numpy_head(progs["cnn"].init_head(jax.random.PRNGKey(7)))
    return out


def _pipeline(mod, model, heads):
    """cam / cam_b (frontend configs), cnn / cnn_b (one model signature,
    two weight draws) and det, all on one spec and compile signature."""
    P = jpipe if mod is jfpca else ppipe
    kw = {} if mod is jfpca else {"device": "cpu"}
    pipe = P.FPCAPipeline(model, backend="basis", **kw)
    bn = np.arange(C_O, dtype=np.float32)
    pipe.register("cam", _spec(mod), _kernel(0), bn)
    pipe.register("cam_b", _spec(mod), _kernel(1))
    progs = _model_progs(mod)
    for name, prog, seed in (("cnn", progs["cnn"], 2), ("cnn_b", progs["cnn"], 3), ("det", progs["det"], 4)):
        hp = heads[name] if mod is jfpca else head_params_from_numpy(heads[name], device="cpu")
        pipe.register(name, prog, _kernel(seed), bn, head_params=hp)
    return pipe


def _frames(seed: int, n: int = TICKS) -> np.ndarray:
    """A moving object, then a static stretch (zero-kept ticks)."""
    cam = SyntheticMovingObject((H, W), seed=seed, radius=4.0)
    f = np.stack([cam.frame_at(t) for t in range(n)])
    f[n - 3:] = f[n - 4]
    return f


STREAMS = {
    "s0": ("cam", {}),
    "s1": ("cam", {"events": True}),
    "s2": ("cnn", {}),
    "s3": ("det", {}),
    "s4": (("cam", "cam_b"), {"gate": "per-config"}),
    "s5": (("cnn", "cnn_b"), {"events": True}),
}


def _server(mod, pipe, depth: int = 2, streams=STREAMS, **kw):
    S = j_streaming if mod is jfpca else streaming
    gate = mod.DeltaGateConfig(**GATE)
    server = S.StreamServer(pipe, gate, depth=depth, **kw)
    for sid, (cfg, opts) in streams.items():
        opts = dict(opts)
        if opts.get("gate") == "per-config":
            opts["gate"] = {"cam": gate, "cam_b": mod.DeltaGateConfig(threshold=0.06, hysteresis=0, keyframe_interval=0)}
        server.add_stream(sid, cfg, **opts)
    return server


def _ticks(streams=STREAMS) -> list[dict]:
    frames = {sid: _frames(seed=10 + i) for i, sid in enumerate(streams)}
    return [{sid: f[t] for sid, f in frames.items()} for t in range(TICKS)]


def _flat(server, ticks) -> list:
    return [r for rs in server.run(ticks) for r in rs]


@pytest.fixture(scope="module")
def served(bucket_model, port_model, heads):
    """Both servers over the same 8 ticks of the six streams."""
    jp, pp = _pipeline(jfpca, bucket_model, heads), _pipeline(fpca, port_model, heads)
    js, ps = _server(jfpca, jp), _server(fpca, pp)
    ticks = _ticks()
    return {"j": _flat(js, ticks), "p": _flat(ps, ticks), "js": js, "ps": ps, "jp": jp, "pp": pp, "ticks": ticks}


def _same_packet(a, b) -> None:
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.stream_id, a.frame_idx, a.grid_shape, a.block) == (b.stream_id, b.frame_idx, b.grid_shape, b.block)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.polarity, b.polarity)


def _logits_close(results, jpipe_, spec) -> None:
    """Model-config logits against the reference's head on the port's own
    effective maps, rebuilt from the port's counts and masks."""
    by = {}
    for r in results:
        by.setdefault((r.stream_id, r.config), []).append(r)
    for (sid, name), rs in by.items():
        jcfg = jpipe_._configs[name]
        if not isinstance(jcfg, jfpca.ProgrammedModel):
            continue
        eff = np.zeros_like(rs[0].counts)
        for r in rs:
            keep = active_window_mask(spec, r.block_mask) if r.block_mask is not None else np.ones(eff.shape[:2], bool)
            eff = np.where(keep[..., None], r.counts, eff)
            want = np.asarray(jcfg.model.apply_head(jcfg.head_params, eff[None]))[0]
            got = r.logits
            tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{sid}/{name} tick {r.frame_idx}")


SERVER_STATS = ("ticks", "frames", "windows_total", "windows_kept", "launches_skipped", "bucket_switches",
                "bucket_shrinks_deferred", "segments", "segment_ticks", "fused_head_calls")


@pytest.mark.zoo
def test_server_matches_reference(served):
    got, want = served["p"], served["j"]
    assert [(r.stream_id, r.frame_idx, r.config) for r in got] == [(r.stream_id, r.frame_idx, r.config) for r in want]
    for a, b in zip(got, want):
        assert a.kept_windows == b.kept_windows and a.total_windows == b.total_windows
        if b.block_mask is None:
            assert a.block_mask is None
        else:
            np.testing.assert_array_equal(a.block_mask, b.block_mask)
        _same_packet(a.events, b.events)
        assert (a.detections is None) == (b.detections is None)
    counts_close(np.stack([r.counts for r in got]), np.stack([r.counts for r in want]))
    _logits_close(got, served["jp"], _spec(fpca))
    ps, js = served["ps"], served["js"]
    assert {k: getattr(ps.stats, k) for k in SERVER_STATS} == {k: getattr(js.stats, k) for k in SERVER_STATS}
    assert ps.stats.fused_head_calls == TICKS      # s5's two cnn configs share one head pass a tick
    for sid in STREAMS:
        s, j = ps.sessions[sid], js.sessions[sid]
        for name in s.configs:
            st, jst = s.state_for(name), j.state_for(name)
            assert st.changed_total == jst.changed_total
            np.testing.assert_array_equal(st.age, jst.age)


def _own_handle(pipe, name, model):
    cfg = pipe._configs[name]
    kw = dict(device="cpu", backend="basis", model=model, weights=cfg.kernel, bn_offset=cfg.bn_offset)
    if isinstance(cfg, fpca.ProgrammedModel):
        return fpca.compile(cfg.model, head_params=cfg.head_params, **kw)
    return fpca.compile(cfg.program, **kw)


@pytest.mark.zoo
def test_server_cameras_equal_their_own_stream_bitwise(served, port_model, heads):
    got = served["p"]
    ticks = served["ticks"]
    for sid in ("s0", "s1", "s2", "s3"):
        name = STREAMS[sid][0]
        handle = _own_handle(served["pp"], name, port_model)
        solo = list(handle.stream([t[sid] for t in ticks], gate=fpca.DeltaGateConfig(**GATE), controller=None))
        mine = [r for r in got if r.stream_id == sid]
        assert len(mine) == len(solo) == TICKS
        for a, b in zip(mine, solo):
            np.testing.assert_array_equal(a.counts, b.counts)
            np.testing.assert_array_equal(a.block_mask, b.block_mask)
            assert a.kept_windows == b.kept_windows
            if b.detections is not None:
                np.testing.assert_array_equal(a.detections.scores, b.detections.scores)
                np.testing.assert_array_equal(a.detections.boxes, b.detections.boxes)
            elif b.logits is not None:
                np.testing.assert_array_equal(a.logits, b.logits)
    # depth does not change a bit
    pp = _pipeline(fpca, port_model, heads)
    again = _flat(_server(fpca, pp, depth=1), ticks)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.counts, b.counts)
        if b.logits is not None:
            np.testing.assert_array_equal(a.logits, b.logits)


def test_fanout_results_equal_each_config_alone_bitwise(served, port_model, heads):
    """s4 gates cam and cam_b each with its own gate through one stacked
    launch a tick; s5 fans one camera to two model configs (fused heads)."""
    got, ticks = served["p"], served["ticks"]
    pp = _pipeline(fpca, port_model, heads)
    per = {"cam": fpca.DeltaGateConfig(**GATE),
           "cam_b": fpca.DeltaGateConfig(threshold=0.06, hysteresis=0, keyframe_interval=0)}
    for sid, names in (("s4", ("cam", "cam_b")), ("s5", ("cnn", "cnn_b"))):
        for name in names:
            server = streaming.StreamServer(pp, per.get(name, fpca.DeltaGateConfig(**GATE)))
            server.add_stream("solo", name)
            solo = list(server.serve("solo", [t[sid] for t in ticks]))
            mine = [r for r in got if r.stream_id == sid and r.config == name]
            for a, b in zip(mine, solo):
                np.testing.assert_array_equal(a.counts, b.counts)
                np.testing.assert_array_equal(a.block_mask, b.block_mask)
                if b.logits is not None:
                    np.testing.assert_array_equal(a.logits, b.logits)
    # fused shared heads against one head pass per config
    unfused = streaming.StreamServer(pp, fpca.DeltaGateConfig(**GATE), fuse_shared_heads=False)
    unfused.add_stream("s5", ("cnn", "cnn_b"))
    plain = _flat(unfused, [{"s5": t["s5"]} for t in ticks])
    fused = [r for r in got if r.stream_id == "s5"]
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a.logits, b.logits)
    assert unfused.stats.fused_head_calls == 0


@pytest.mark.segment
def test_segments_equal_ticks_and_interleave_on_a_shared_handle(port_model, heads):
    pp = _pipeline(fpca, port_model, heads)
    f = {sid: _frames(seed=20 + i, n=12) for i, sid in enumerate(("a", "b"))}
    streams = {"a": ("cnn", {}), "b": ("cnn", {"events": True})}
    ticks = [{sid: fr[t] for sid, fr in f.items()} for t in range(12)]
    per_tick = _flat(_server(fpca, pp, streams=streams), ticks)
    # the two streams share one model handle and so one segment executable;
    # their segments interleave a → b → a → b
    seg_server = _server(fpca, pp, streams=streams)
    gens = {sid: seg_server.serve_segments(sid, f[sid], segment_length=4) for sid in f}
    seg = {sid: [] for sid in f}
    for _ in range(3):
        for sid, g in gens.items():
            seg[sid].extend(next(g) for _ in range(4))
    for sid in f:
        mine = [r for r in per_tick if r.stream_id == sid]
        for a, b in zip(seg[sid], mine):
            assert a.frame_idx == b.frame_idx and a.kept_windows == b.kept_windows
            np.testing.assert_array_equal(a.counts, b.counts)
            np.testing.assert_array_equal(a.block_mask, b.block_mask)
            np.testing.assert_array_equal(a.logits, b.logits)
            _same_packet(a.events, b.events)
    assert seg_server.event_taps["b"].stats.events == seg_server.sessions["b"]._primary.changed_total
    assert seg_server.stats.segments == 6 and seg_server.stats.segment_ticks == 24
    # per-tick serving, then segments, then ticks again on one stream
    mixed = _server(fpca, pp, streams={"a": ("cnn", {})})
    out = _flat(mixed, [{"a": f["a"][t]} for t in range(3)])
    out += mixed.run_segment("a", f["a"][3:9])
    out += _flat(mixed, [{"a": f["a"][t]} for t in range(9, 12)])
    for a, b in zip(out, [r for r in per_tick if r.stream_id == "a"]):
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.logits, b.logits)


@pytest.mark.segment
def test_segment_serving_and_events_match_reference(bucket_model, port_model, heads):
    jp, pp = _pipeline(jfpca, bucket_model, heads), _pipeline(fpca, port_model, heads)
    streams = {"s": ("cam", {"events": True})}
    frames = _frames(seed=30, n=10)
    js, ps = _server(jfpca, jp, streams=streams), _server(fpca, pp, streams=streams)
    want = list(js.serve_segments("s", frames, segment_length=4))
    got = list(ps.serve_segments("s", frames, segment_length=4))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.frame_idx == b.frame_idx and a.kept_windows == b.kept_windows
        np.testing.assert_array_equal(a.block_mask, b.block_mask)
        _same_packet(a.events, b.events)
    counts_close(np.stack([r.counts for r in got]), np.stack([r.counts for r in want]))
    assert {k: getattr(ps.stats, k) for k in SERVER_STATS} == {k: getattr(js.stats, k) for k in SERVER_STATS}
    # the re-derived packets equal the per-tick ones of the same frames
    pkts = events.segment_events(_spec(fpca), frames, None, GATE["threshold"], "s", 0, device="cpu")
    jpkts = j_events.segment_events(_spec(jfpca), frames, None, GATE["threshold"], "s", 0)
    for a, b, r in zip(pkts, jpkts, got):
        _same_packet(a, b)
        _same_packet(a, r.events)
        np.testing.assert_array_equal(a.raster(), b.raster())


@pytest.mark.zoo
def test_event_taps_reconcile_with_the_gate(served):
    for sid in ("s1", "s5"):
        tap, jtap = served["ps"].event_taps[sid], served["js"].event_taps[sid]
        assert tap.stats.as_dict() == jtap.stats.as_dict()
        assert tap.stats.events == tap.stats.events_pos + tap.stats.events_neg
        assert tap.stats.events == served["ps"].sessions[sid]._primary.changed_total
        assert tap.stats._labels["arch"] == "events" and tap.stats._labels["stream"] == sid


def test_errors_match_reference(bucket_model, port_model, heads):
    jp, pp = _pipeline(jfpca, bucket_model, heads), _pipeline(fpca, port_model, heads)
    js, ps = _server(jfpca, jp, streams={"s0": ("cam", {})}), _server(fpca, pp, streams={"s0": ("cam", {})})
    jp.register("other", jfpca.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=4), _kernel(5))
    pp.register("other", fpca.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=4), _kernel(5))
    cases = [
        lambda F, S, srv: srv.add_stream("s0", "cam"),
        lambda F, S, srv: srv.add_stream("x", "nope"),
        lambda F, S, srv: srv.add_stream("x", ("cam", "other")),
        lambda F, S, srv: srv.add_stream("x", ("cam", "cam_b"), gate={"cam": F.DeltaGateConfig()}),
        lambda F, S, srv: srv.add_stream("x", ("cam", "cam_b"), gate=None,
                                         controller={"cam": F.GateControllerConfig()}),
        lambda F, S, srv: srv.add_stream("x", ("cam", "cam_b"), gate={"cam": F.DeltaGateConfig(),
                                                                     "cam_b": F.DeltaGateConfig()}, events=True),
        lambda F, S, srv: srv.add_stream("x", "cam", gate=None, events=True),
        lambda F, S, srv: list(srv.run([{"ghost": np.zeros((H, W, 3), np.float32)}])),
        lambda F, S, srv: srv.run_segment("ghost", np.zeros((2, H, W, 3), np.float32)),
        lambda F, S, srv: list(srv.serve_segments("s0", [], segment_length=0)),
        lambda F, S, srv: S.StreamServer(srv.pipeline, depth=0),
    ]
    for case in cases:
        same_error(lambda: case(jfpca, j_streaming, js), lambda: case(fpca, streaming, ps))
    assert "x" not in ps.sessions and "x" not in ps.event_taps     # no half-attached stream
    for mod, S, srv in ((jfpca, j_streaming, js), (fpca, streaming, ps)):
        srv.add_stream("fan", ("cam", "cam_b"))
    same_error(lambda: js.run_segment("fan", np.zeros((2, H, W, 3), np.float32)),
                lambda: ps.run_segment("fan", np.zeros((2, H, W, 3), np.float32)))


@pytest.mark.parametrize("binning,keep_frac", [(1, 0.4), (2, 0.25), (1, 1.0)])
def test_saliency_mask_matches_reference(binning, keep_frac):
    kw = dict(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=5, binning=binning)
    img = np.random.default_rng(binning).uniform(0, 1, (H, W, 3)).astype(np.float32)
    got = saliency.saliency_mask(img, fpca.FPCASpec(**kw), keep_frac)
    want = j_saliency.saliency_mask(img, jfpca.FPCASpec(**kw), keep_frac)
    np.testing.assert_array_equal(got, want)
    same_error(lambda: j_saliency.saliency_mask(img, jfpca.FPCASpec(**kw), 0.0),
                lambda: saliency.saliency_mask(img, fpca.FPCASpec(**kw), 0.0))


def test_server_runs_on_the_pipeline_device(port_model, heads):
    pp = _pipeline(fpca, port_model, heads)
    server = streaming.StreamServer(pp)
    s = server.add_stream("s", "cam")
    assert server.device == s.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ppipe.FPCAPipeline(port_model)
