"""The port's streaming segments (``run_segment``) and per-tick ``stream()``
against the reference's on the ``basis`` backend, on 20x20 frames (a 4x4
window grid, 3x3 skip blocks) and K <= 8, with the reference's parameters
handed over as numpy.

Tolerances, each with its reason:

* block masks, kept windows, keyframes, ``rows_executed``,
  ``suggested_bucket``, ``ticks`` and the serving stats: equal (the gate's
  effective frames are bit-equal to the reference's and its block deltas
  within a few ulps, far from the threshold on these scenes);
* counts: at most 1 ADC count and fewer than 5% off (round-half flips of
  f32 sums taken in another order);
* logits: within 1e-5 of the largest logit of the reference's head applied
  to the port's own effective activation maps (rebuilt on the host from
  the port's counts and masks), so any distance from the reference's own
  logits is what the count flips carry through the head;
* within the port, bit for bit: a segment against ``stream()``, chained
  segments against one, an early-exit segment against the prefix of the
  full scan, any bucket against the M bucket.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import counts_close
from repro.core.mapping import active_window_mask as j_active_window_mask
from repro.serving import streaming as j_streaming
from repro_torch import fpca
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy, segment_state_from_numpy
from repro_torch.core.mapping import active_window_mask
from repro_torch.fpca.backends import _CapturedSegment
from repro_torch.serving import streaming

H = W = 20
C_O = 3
M = 16
GATE = dict(threshold=0.02, hysteresis=1, keyframe_interval=4)
pytestmark = pytest.mark.segment


def _spec(mod):
    return mod.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=5)


def _kernel(seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(C_O, 5, 5, 3)) * 0.2).astype(np.float32)


def _scene(k: int, seed: int = 0) -> np.ndarray:
    """A moving blob over a fixed background, two static stretches (zero
    kept ticks), keyframe crossings."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, size=(H, W, 3)).astype(np.float32)
    frames = np.empty((k, H, W, 3), np.float32)
    for t in range(k):
        f = base.copy()
        if t % 5 < 3:
            c = (t * 3) % (H - 6)
            f[c:c + 6, c:c + 6] += 0.5
        frames[t] = np.clip(f, 0, 1)
    frames[3:5] = frames[2]
    if k > 6:
        frames[-2:] = frames[-3]
    return frames


def _program(mod, arch: str | None, gate: dict = GATE, precision: str = "f32"):
    fe = mod.FPCAProgram(spec=_spec(mod), gate=mod.DeltaGateConfig(**gate))
    if arch is None:
        return fe
    if arch == "chain":
        return mod.FPCAModelProgram(frontend=fe, head=(mod.DenseSpec(8, activation="relu"), mod.DenseSpec(3)),
                                    input_scale=0.25, precision=precision)
    build = jfpca.build_model if mod is jfpca else fpca.build_model
    return build({"arch": arch, "frontend": fe, "width": 4, "n_classes": 3})


def _numpy_head(params):
    if isinstance(params, dict):
        return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


def _pair(bucket_model, port_model, arch=None, gate=GATE, precision="f32", kernel_seed=0):
    """The reference's and the port's handle on the same weights."""
    jp, pp = _program(jfpca, arch, gate, precision), _program(fpca, arch, gate, precision)
    kw = dict(weights=_kernel(kernel_seed), bn_offset=np.arange(C_O, dtype=np.float32))
    jkw, pkw = dict(kw), dict(kw)
    if arch is not None:
        jhead = jp.init_head(jax.random.PRNGKey(1))
        if precision == "int8":
            calib = np.random.default_rng(2).integers(0, 256, (2, 4, 4, C_O)).astype(np.float32)
            from repro.models import quant as jquant

            jhead = jquant.quantize_head_params(jp, jhead, sample_counts=calib)
        jhead = _numpy_head(jhead)
        jkw["head_params"] = jhead
        pkw["head_params"] = head_params_from_numpy(jhead, device="cpu")
    j = jfpca.compile(jp, backend="basis", model=bucket_model, **jkw)
    p = fpca.compile(pp, backend="basis", device="cpu", model=port_model, **pkw)
    return j, p


def _same_bookkeeping(seg, jseg) -> None:
    assert seg.ticks == jseg.ticks and seg.length == jseg.length and seg.gated == jseg.gated
    assert seg.first_frame_idx == jseg.first_frame_idx
    np.testing.assert_array_equal(seg.block_masks, jseg.block_masks)
    np.testing.assert_array_equal(seg.kept_windows, jseg.kept_windows)
    np.testing.assert_array_equal(seg.keyframes, jseg.keyframes)
    np.testing.assert_array_equal(seg.rows_executed, jseg.rows_executed)
    assert seg.state.suggested_bucket == jseg.state.suggested_bucket
    for name in ("has_prev", "age", "frame_idx"):
        np.testing.assert_array_equal(getattr(seg.state, name).numpy(), np.asarray(getattr(jseg.state, name)))


def _eff_maps(seg, spec) -> np.ndarray:
    """The effective activation map after each tick, rebuilt on the host."""
    counts = seg.counts.numpy()
    eff = np.zeros_like(counts[0])
    out = []
    for t in range(seg.ticks):
        keep = active_window_mask(spec, seg.block_masks[t]) if seg.gated else np.ones(counts.shape[1:3], bool)
        eff = np.where(keep[..., None], counts[t], eff)
        out.append(eff)
    return np.stack(out)


def _logits_close(seg, jseg, jm, spec) -> None:
    """Port logits against the reference's head on the port's effective
    maps, and so within what the count flips allow of the reference's."""
    want = np.asarray(jm.model_program.apply_head(jm.head_params, _eff_maps(seg, spec)))
    got = seg.logits.numpy()[: seg.ticks]
    tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if np.array_equal(seg.counts.numpy(), np.asarray(jseg.counts)):
        np.testing.assert_allclose(got, np.asarray(jseg.logits)[: seg.ticks], rtol=0, atol=tol)


def _same_as_stream(handle, frames, seg, gate="program") -> None:
    """Inside the port: the segment equals per-tick stream(), bit for bit."""
    kw = {} if gate == "program" else {"gate": gate}
    results = list(handle.stream(frames, controller=None, **kw))
    assert len(results) == seg.ticks
    for t, r in enumerate(results):
        np.testing.assert_array_equal(seg.counts[t].numpy(), r.counts, err_msg=f"counts tick {t}")
        assert int(seg.kept_windows[t]) == r.kept_windows
        if r.block_mask is not None:
            np.testing.assert_array_equal(seg.block_masks[t], r.block_mask)
        if r.detections is not None:
            det = seg.detections()[t]
            np.testing.assert_array_equal(det.scores, r.detections.scores)
            np.testing.assert_array_equal(det.boxes, r.detections.boxes)
        elif r.logits is not None:
            np.testing.assert_array_equal(seg.logits[t].numpy(), r.logits, err_msg=f"logits tick {t}")


@pytest.mark.parametrize("gated", [True, False])
def test_frontend_segment_matches_reference_and_stream(bucket_model, port_model, gated):
    j, p = _pair(bucket_model, port_model)
    frames = _scene(8)
    kw = {} if gated else {"gate": None}
    jseg, seg = j.run_segment(frames, length=8, **kw), p.run_segment(frames, length=8, **kw)
    _same_bookkeeping(seg, jseg)
    counts_close(seg.counts.numpy(), jseg.counts)
    assert p.stats.as_dict() == j.stats.as_dict()
    assert seg.counts.device.type == "cpu" and seg.logits is None
    if gated:
        assert (seg.kept_windows == 0).any() and seg.keyframes[0] and seg.keyframes[4]
    else:
        assert (seg.kept_windows == M).all() and not seg.keyframes.any()
    _same_as_stream(p, frames, seg, gate="program" if gated else None)
    key = next(k for k in p.cache_info(verbose=True).resident if "segment" in k)
    assert not isinstance(p._cache._entries[key].__wrapped__, _CapturedSegment)   # eager on the host


def test_chained_segments_equal_one_segment(bucket_model, port_model):
    j, p = _pair(bucket_model, port_model)
    frames = _scene(8, seed=1)
    whole = p.run_segment(frames)
    s1 = p.run_segment(frames[:4])
    s2 = p.run_segment(frames[4:], state=s1.state)
    j1 = j.run_segment(frames[:4])
    j2 = j.run_segment(frames[4:], state=j1.state)
    assert s2.first_frame_idx == 4
    torch.testing.assert_close(torch.cat([s1.counts, s2.counts]), whole.counts, rtol=0, atol=0)
    np.testing.assert_array_equal(np.concatenate([s1.kept_windows, s2.kept_windows]), whole.kept_windows)
    _same_bookkeeping(s1, j1)
    _same_bookkeeping(s2, j2)


@pytest.mark.parametrize("arch,precision", [("chain", "f32"), ("fpca_detect", "f32"), ("chain", "int8")])
def test_model_segments_match_reference_and_stream(bucket_model, port_model, arch, precision):
    """Model segments: the in-segment skip-aware head, logits every tick
    (per-cell maps and ``detections()`` for fpca_detect; the int8 head and
    the int8 transfer table on ``basis``).  Zero-kept ticks repeat the
    previous logits exactly."""
    j, p = _pair(bucket_model, port_model, arch=arch, precision=precision)
    frames = _scene(8, seed=2)
    jseg, seg = j.run_segment(frames), p.run_segment(frames)
    _same_bookkeeping(seg, jseg)
    counts_close(seg.counts.numpy(), jseg.counts)
    assert p.stats.as_dict() == j.stats.as_dict()
    assert tuple(seg.logits.shape) == (8,) + tuple(p.head_out_shape)
    _logits_close(seg, jseg, j, p.spec)
    for t in np.flatnonzero(seg.kept_windows == 0):
        assert torch.equal(seg.logits[t], seg.logits[t - 1])
    np.testing.assert_array_equal(seg.state.eff.numpy(), _eff_maps(seg, p.spec)[-1])
    _same_as_stream(p, frames, seg)
    if arch == "fpca_detect":
        dets, jdets = seg.detections(), jseg.detections()
        assert len(dets) == 8 and dets[0].scores.shape == jdets[0].scores.shape
    else:
        with pytest.raises(ValueError, match="not a detection segment"):
            seg.detections()


def test_early_exit_is_a_prefix_and_resumes_exactly(bucket_model, port_model):
    gate = dict(threshold=0.02, hysteresis=0, keyframe_interval=0)
    j, p = _pair(bucket_model, port_model, gate=gate)
    frames = np.random.default_rng(5).uniform(0, 1, (8, H, W, 3)).astype(np.float32)
    frames[4:] = frames[3]
    full = p.run_segment(frames)
    seg, jseg = p.run_segment(frames, early_exit=2), j.run_segment(frames, early_exit=2)
    _same_bookkeeping(seg, jseg)
    assert seg.ticks == 6 and (seg.kept_windows[4:6] == 0).all()
    assert torch.equal(seg.counts[: seg.ticks], full.counts[: seg.ticks])
    assert not bool(seg.counts[seg.ticks:].any())
    rest = p.run_segment(frames[seg.ticks:], state=seg.state)
    assert torch.equal(rest.counts, full.counts[seg.ticks:])
    np.testing.assert_array_equal(rest.kept_windows, full.kept_windows[seg.ticks:])
    skipped = [int((r.kept_windows[: r.ticks] == 0).sum()) for r in (full, seg, rest)]
    assert j.stats.launches_skipped == skipped[1] and p.stats.launches_skipped == sum(skipped)
    assert p.stats.segment_ticks == full.ticks + seg.ticks + rest.ticks == 16


@pytest.mark.parametrize("m_bucket", [1, 2, 3, 15, 16])
def test_bucket_edges(bucket_model, port_model, m_bucket):
    """Any bucket serves the same counts as the M bucket; the accounting
    bills the bucket for ticks that fit it, M for busier ones, nothing for
    zero-kept ticks, as the reference does."""
    j, p = _pair(bucket_model, port_model)
    frames = _scene(8, seed=3)
    ref = p.run_segment(frames)
    seg, jseg = p.run_segment(frames, m_bucket=m_bucket), j.run_segment(frames, m_bucket=m_bucket)
    assert torch.equal(seg.counts, ref.counts)
    _same_bookkeeping(seg, jseg)
    kept = seg.kept_windows
    np.testing.assert_array_equal(seg.rows_executed, np.where(kept == 0, 0, np.where(kept > m_bucket, M, m_bucket)))


def test_reprogram_between_segments_builds_nothing(bucket_model, port_model):
    """A weight rewrite and a threshold change between segments build no
    executable; the chained output equals a per-tick loop that switches
    weights at the same tick, and the reference's within the count limit."""
    j, p = _pair(bucket_model, port_model)
    frames = _scene(8, seed=4)
    k2 = _kernel(7)
    s1, j1 = p.run_segment(frames[:4]), j.run_segment(frames[:4])
    misses = p.cache_info().misses
    p.reprogram(k2)
    j.reprogram(k2)
    s2, j2 = p.run_segment(frames[4:], state=s1.state), j.run_segment(frames[4:], state=j1.state)
    gate = dataclasses.replace(p.program.gate, threshold=0.05)
    s3 = p.run_segment(frames[4:], state=s1.state, gate=gate)
    j3 = j.run_segment(frames[4:], state=j1.state, gate=jfpca.DeltaGateConfig(**{**GATE, "threshold": 0.05}))
    assert p.cache_info().misses == misses
    for seg, jseg in ((s2, j2), (s3, j3)):
        _same_bookkeeping(seg, jseg)
        counts_close(seg.counts.numpy(), jseg.counts)
    _, host = _pair(bucket_model, port_model)

    def feed():   # stream() launches each tick as it pulls the frame
        for i, f in enumerate(frames):
            if i == 4:
                host.reprogram(k2)
            yield f

    want = np.stack([r.counts for r in host.stream(feed(), controller=None)])
    np.testing.assert_array_equal(torch.cat([s1.counts, s2.counts]).numpy(), want)


def test_segment_continues_from_a_reference_carry(bucket_model, port_model):
    """The reference serves the first segment; its state, handed over as
    numpy, starts the port's second, which equals the port's own second
    segment bit for bit and the reference's within the count limit."""
    j, p = _pair(bucket_model, port_model, arch="chain")
    frames = _scene(8, seed=6)
    j1 = j.run_segment(frames[:4])
    j2 = j.run_segment(frames[4:], state=j1.state)
    state = segment_state_from_numpy(**{k: (np.asarray(v) if v is not None and not isinstance(v, int) else v)
                                        for k, v in dataclasses.asdict(j1.state).items()}, device="cpu")
    own1 = p.run_segment(frames[:4])
    for name in ("has_prev", "prev_eff", "age", "frame_idx"):
        assert torch.equal(getattr(state, name), getattr(own1.state, name)), name
    s2 = p.run_segment(frames[4:], state=state)
    own2 = p.run_segment(frames[4:], state=own1.state)
    _same_bookkeeping(s2, j2)
    counts_close(s2.counts.numpy(), j2.counts)
    if torch.equal(state.eff, own1.state.eff):
        assert torch.equal(s2.counts, own2.counts) and torch.equal(s2.logits, own2.logits)
    assert s2.first_frame_idx == 4 and state.suggested_bucket == j1.state.suggested_bucket


def test_session_absorbs_a_segment_and_continues_like_the_reference(bucket_model, port_model):
    j, p = _pair(bucket_model, port_model)
    frames = _scene(8, seed=7)
    seg, jseg = p.run_segment(frames[:5]), j.run_segment(frames[:5])
    gate, jgate = fpca.DeltaGateConfig(**GATE), jfpca.DeltaGateConfig(**GATE)
    s = streaming.StreamSession("s", "c", p.spec, gate, device="cpu")
    js = j_streaming.StreamSession("s", "c", j.spec, jgate)
    stepped = streaming.StreamSession("s", "c", p.spec, gate, device="cpu")
    for f in frames[:5]:
        stepped.step(f)
    s.absorb_segment(seg)
    js.absorb_segment(jseg)
    for f in frames[5:]:
        keep = s.step(f)
        np.testing.assert_array_equal(keep, js.step(f))
        np.testing.assert_array_equal(keep, stepped.step(f))
    np.testing.assert_array_equal(s.last_window_mask, j_active_window_mask(j.spec, js._primary.last_block_mask))
    assert s.energy_report() == js.energy_report() == stepped.energy_report()


def test_segment_arguments_are_checked_like_the_reference(bucket_model, port_model):
    j, p = _pair(bucket_model, port_model)
    frames = _scene(4)
    cases = [(dict(length=8), frames), ({}, frames[0]), (dict(gate=None, early_exit=2), frames),
             (dict(early_exit=0), frames)]
    for kw, f in cases:
        with pytest.raises(ValueError) as want:
            j.run_segment(f, **kw)
        with pytest.raises(ValueError) as got:
            p.run_segment(f, **kw)
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
