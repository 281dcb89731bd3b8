"""The port's batch pipeline (``repro_torch.serving.fpca_pipeline``) against
the reference's ``FPCAPipeline`` on the ``basis`` backend, on 20x20 frames,
with the same seeded numpy inputs and the reference's calibrations handed
over as numpy.

Tolerances, each with its reason:

* counts: at most 1 ADC count and fewer than 5% off (round-half flips of
  f32 sums taken in another order);
* logits: within 1e-5 of the largest logit of the reference's head applied
  to the port's own frontend counts for the same request, so any distance
  from the reference's logits is what the count flips carry through the
  head;
* grouping, stats (requests, batches, merged groups, fan-outs, windows,
  skipped launches, bucket switches, cache hits and misses), channel slices
  and error types and messages: equal;
* within the port, bit for bit: merged against unmerged serving, every
  result against the same group through the config's own ``fpca.compile``
  handle, and a fan-out against each config alone.
"""

from __future__ import annotations

import warnings

import jax
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import counts_close, same_error
from repro.core.curvefit import fit_bucket_model as j_fit
from repro.core.device_models import CircuitParams as JCircuit
from repro.serving import fpca_pipeline as jpipe
from repro_torch import fpca
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.mapping import active_window_mask
from repro_torch.serving import fpca_pipeline as ppipe

H = W = 20
C_O = 3


def _specs(mod) -> dict:
    return {
        "dense": mod.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=5),
        "overlap": mod.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=3, stride=2, max_kernel=3),
        "binned": mod.FPCASpec(image_h=H, image_w=W, out_channels=C_O, kernel=5, stride=5, binning=2),
    }


def _kernel(seed: int, k: int = 5, c_o: int = C_O) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(c_o, k, k, 3)) * 0.2).astype(np.float32)


def _numpy_head(params):
    if isinstance(params, dict):
        return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _models(mod, spec):
    build = jfpca.build_model if mod is jfpca else fpca.build_model
    fe = mod.FPCAProgram(spec=spec)
    return {
        "cnn": build({"arch": "fpca_cnn", "frontend": fe, "hidden": 8, "n_classes": 3}),
        "det": build({"arch": "fpca_detect", "frontend": fe, "width": 4, "n_classes": 2}),
    }


@pytest.fixture(scope="module")
def models(bucket_model):
    """The reference's calibrations (75 and 27 pixels) and the port's copies."""
    m27 = j_fit(n_pixels=27)
    jm = {75: bucket_model, 27: m27}
    pm = {k: bucket_model_from_dict(v.to_dict()) for k, v in jm.items()}
    return jm, pm


@pytest.fixture(scope="module")
def heads():
    jms = _models(jfpca, _specs(jfpca)["dense"])
    return {n: _numpy_head(m.init_head(jax.random.PRNGKey(i + 1))) for i, (n, m) in enumerate(jms.items())}


def _register(pipe, mod, heads, *, models_too: bool = True) -> None:
    specs = _specs(mod)
    bn = np.arange(C_O, dtype=np.float32)
    pipe.register("dense", specs["dense"], _kernel(0), bn)
    pipe.register("dense_b", specs["dense"], _kernel(1))
    pipe.register("overlap", specs["overlap"], _kernel(2, k=3), bn)
    pipe.register("binned", specs["binned"], _kernel(3), bn)
    if models_too:
        for name, prog in _models(mod, specs["dense"]).items():
            hp = heads[name] if mod is jfpca else head_params_from_numpy(heads[name], device="cpu")
            pipe.register(name, prog, _kernel(10 + len(name)), bn, head_params=hp)


def _pair(models, heads, **kw):
    jm, pm = models
    j = jpipe.FPCAPipeline(jm, backend="basis", **kw)
    p = ppipe.FPCAPipeline(pm, backend="basis", device="cpu", **kw)
    _register(j, jfpca, heads)
    _register(p, fpca, heads)
    return j, p


NAMES = ("dense", "dense_b", "overlap", "binned", "cnn", "det")


def _mix(n: int, seed: int, names=NAMES, mask_share: float = 0.25) -> list[tuple[str, np.ndarray, np.ndarray | None]]:
    """A seeded request mix: configs in random order, a share of the
    requests carrying a block mask."""
    rng = np.random.default_rng(seed)
    specs = _specs(fpca)
    out = []
    for _ in range(n):
        name = names[rng.integers(len(names))]
        img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        mask = None
        if rng.random() < mask_share:
            spec = specs["overlap" if name == "overlap" else "binned" if name == "binned" else "dense"]
            bh, bw = -(-spec.eff_h // spec.skip_block), -(-spec.eff_w // spec.skip_block)
            mask = rng.random((bh, bw)) < 0.4
        out.append((name, img, mask))
    return out


def _requests(mod, mix):
    return [mod.FrontendRequest(n, img, m) for n, img, m in mix]


def _raw(x) -> np.ndarray:
    """A result on the host: counts or logits, or a detection map re-joined."""
    if hasattr(x, "scores"):
        return np.concatenate([np.asarray(x.scores), np.asarray(x.boxes)], -1)
    return np.asarray(x)


STATS = ("requests", "batches", "merged_groups", "fanout_batches", "windows_total", "windows_executed",
         "launches_skipped", "bucket_switches", "bucket_shrinks_deferred", "cache_hits", "cache_misses", "evictions")


@pytest.mark.zoo
@pytest.mark.parametrize("cross", [False, True])
def test_serve_mix_matches_reference(models, heads, cross):
    j, p = _pair(models, heads, cross_config_batching=cross)
    mix = _mix(24, seed=5)
    want = j.serve(_requests(jpipe, mix))
    got = p.serve(_requests(ppipe, mix))
    assert j.group_requests(_requests(jpipe, mix)) == p.group_requests(_requests(ppipe, mix))
    assert {k: getattr(p.stats, k) for k in STATS} == {k: getattr(j.stats, k) for k in STATS}
    assert p.stats.merged_groups == (1 if cross else 0)
    flat_got, flat_want = [], []
    for (name, img, mask), g, w in zip(mix, got, want):
        cfg = p._configs[name]
        if isinstance(cfg, fpca.ProgrammedModel):
            # the reference's head on the port's own frontend counts
            handle = p.model_handle_for(cfg.model)
            wk = None if mask is None else active_window_mask(cfg.spec, mask)[None]
            counts = handle.run_frontend_weighted(cfg.kernel, cfg.bn_offset, img[None], wk).numpy()
            jcfg = j._configs[name]
            ref = np.asarray(jcfg.model.apply_head(jcfg.head_params, counts))[0]
            tol = 1e-5 * max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(_raw(g), ref, rtol=0, atol=tol)
        else:
            flat_got.append(_raw(g))
            flat_want.append(_raw(w))
    counts_close(np.concatenate([x.ravel() for x in flat_got]), np.concatenate([x.ravel() for x in flat_want]))


@pytest.mark.zoo
def test_merged_equals_unmerged_and_own_handles_bitwise(models, heads):
    _, pm = models
    mix = _mix(20, seed=6)
    results = {}
    for cross in (False, True):
        p = ppipe.FPCAPipeline(pm, backend="basis", device="cpu", cross_config_batching=cross)
        _register(p, fpca, heads)
        results[cross] = p.serve(_requests(ppipe, mix))
    for a, b in zip(results[False], results[True]):
        np.testing.assert_array_equal(_raw(a), _raw(b))
    # every group against its config's own compiled handle on the same batch
    groups = p.group_requests(_requests(ppipe, mix))
    for name, idxs in groups.items():
        cfg = p._configs[name]
        kw = dict(device="cpu", backend="basis", model=pm[cfg.spec.n_active_pixels], weights=cfg.kernel,
                  bn_offset=cfg.bn_offset)
        if isinstance(cfg, fpca.ProgrammedModel):
            own = fpca.compile(cfg.model, head_params=cfg.head_params, **kw)
        else:
            own = fpca.compile(cfg.program, **kw)
        images = np.stack([mix[i][1] for i in idxs])
        masks = [mix[i][2] for i in idxs]
        wk = None
        if any(m is not None for m in masks):
            wk = np.stack([active_window_mask(cfg.spec, m) if m is not None
                           else np.ones(own.out_shape[:2], bool) for m in masks])
        want = own.run(images, window_keep=wk)
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(_raw(results[False][i]), _raw(want)[j])


@pytest.mark.parametrize("names", [("dense", "dense_b"), ("dense", "cnn", "dense_b")])
def test_fanout_batch_matches_reference_and_each_config(models, heads, names):
    j, p = _pair(models, heads)
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    keep = rng.random((3, 4, 4)) < 0.5
    want = np.asarray(j.run_config_batch(list(names), images, keep))
    got = p.run_config_batch(list(names), images, keep)
    counts_close(got.numpy(), want)
    assert p.config_channel_slices(names) == j.config_channel_slices(names)
    for name, lo, hi in p.config_channel_slices(names):
        cfg = p._configs[name]
        solo = p.handle_for(cfg.program, C_O).run_weighted(cfg.kernel, cfg.bn_offset, images, keep)
        assert torch.equal(got[..., lo:hi], solo)
    assert p.stats.fanout_batches == j.stats.fanout_batches == 1
    # the stacked planes are cached per fan-out tuple
    assert p._stacked_planes(list(names), [p._configs[n] for n in names]) is p._stacked[tuple(names)]


@pytest.mark.parametrize("widths", [(8, 8), (8, 4), (4, 6), (8, 8, 8, 8)], ids=lambda w: "+".join(map(str, w)))
def test_stacked_fanout_equals_each_config_alone(models, widths):
    """Channel stacks as the server and the merged pipeline launch them: 8 +
    8 (the server's fan-out), 8 + 4 (adaptive_stream's), 4 + 6 (a config
    starting mid-way through a block of 8) and 4 x 8 (the merged group).
    Each config's slice equals its own launch bit for bit, and the slices
    are the stack's layout, the reference's."""
    jm, pm = models
    j = jpipe.FPCAPipeline(jm, backend="basis")
    p = ppipe.FPCAPipeline(pm, backend="basis", device="cpu")
    names = [f"s{i}" for i in range(len(widths))]
    rng = np.random.default_rng(len(widths) * 10 + widths[-1])
    for name, c_o, seed in zip(names, widths, range(20, 20 + len(widths))):
        bn = rng.integers(0, 24, c_o).astype(np.float32)
        for pipe, mod in ((j, jfpca), (p, fpca)):   # one spec, as a fan-out needs; the kernel sets c_o
            pipe.register(name, _specs(mod)["dense"], _kernel(seed, c_o=c_o), bn)
    images = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    keep = rng.random((3, 4, 4)) < 0.5
    got = p.run_config_batch(names, images, keep)
    slices = p.config_channel_slices(names)
    assert slices == j.config_channel_slices(names)
    assert [(lo, hi) for _, lo, hi in slices] == [(sum(widths[:i]), sum(widths[:i + 1])) for i in range(len(widths))]
    assert got.shape[-1] == sum(widths)
    for name, lo, hi in slices:
        cfg = p._configs[name]
        solo = p.handle_for(cfg.program, hi - lo).run_weighted(cfg.kernel, cfg.bn_offset, images, keep)
        assert torch.equal(got[..., lo:hi], solo)


@pytest.mark.segment
def test_run_config_segment_matches_reference(models, heads):
    j, p = _pair(models, heads)
    rng = np.random.default_rng(8)
    frames = np.repeat(rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32), 6, axis=0)
    frames[2:4, :8, :8] += 0.3
    gate_kw = dict(threshold=0.02, hysteresis=1, keyframe_interval=4)
    for name in ("dense", "cnn"):
        jseg = j.run_config_segment(name, frames, gate=jfpca.DeltaGateConfig(**gate_kw))
        seg = p.run_config_segment(name, frames, gate=fpca.DeltaGateConfig(**gate_kw))
        np.testing.assert_array_equal(seg.block_masks, jseg.block_masks)
        np.testing.assert_array_equal(seg.kept_windows, jseg.kept_windows)
        counts_close(seg.counts.numpy(), np.asarray(jseg.counts))
    assert {k: getattr(p.stats, k) for k in STATS} == {k: getattr(j.stats, k) for k in STATS}
    assert p.stats.segments == 2 and p.stats.segment_ticks == 12


def test_cache_bounds_and_handle_sharing_match_reference(models, heads):
    for cap in (2, 8):
        j, p = _pair(models, heads, cache_capacity=cap)
        mix = _mix(12, seed=9, names=("dense", "dense_b", "overlap", "binned"), mask_share=0.0)
        for _ in range(2):
            j.serve(_requests(jpipe, mix))
            p.serve(_requests(ppipe, mix))
        assert p.cache_size == j.cache_size
        assert {k: getattr(p.stats, k) for k in STATS} == {k: getattr(j.stats, k) for k in STATS}
        # dense and dense_b share one handle: weights are call arguments
        assert p.handle_for(p._configs["dense"].program) is p.handle_for(p._configs["dense_b"].program)
        assert sorted(map(str, p._handles)) == sorted(map(str, j._handles))


def test_errors_match_reference(models, heads):
    jm, pm = models
    j, p = _pair(models, heads)
    js, ps = _specs(jfpca), _specs(fpca)
    zero = np.zeros((H, W, 3), np.float32)
    cases = [
        lambda F, P, pipe, s: pipe.register("dense", s["dense"], _kernel(0)),
        lambda F, P, pipe, s: pipe.register("x", F.FPCAProgram(spec=s["dense"]), _kernel(0, c_o=2)),
        lambda F, P, pipe, s: pipe.register("x", _models(F, s["dense"])["cnn"], _kernel(0)),
        lambda F, P, pipe, s: pipe.register("x", _models(F, s["dense"])["cnn"], _kernel(0, c_o=4), head_params={}),
        lambda F, P, pipe, s: pipe.register("x", s["dense"], _kernel(0), head_params=[]),
        lambda F, P, pipe, s: pipe.serve([P.FrontendRequest("nope", zero)]),
        lambda F, P, pipe, s: pipe.serve([P.FrontendRequest("dense", np.zeros((7, 7, 3), np.float32))]),
        lambda F, P, pipe, s: pipe.run_config_batch([], zero[None]),
        lambda F, P, pipe, s: pipe.run_config_batch(["dense", "overlap"], zero[None]),
        lambda F, P, pipe, s: pipe.run_config_batch("dense", zero),
        lambda F, P, pipe, s: pipe.run_config_batch("nope", zero[None]),
        lambda F, P, pipe, s: pipe.run_config_segment("nope", zero[None]),
    ]
    for case in cases:
        same_error(lambda: case(jfpca, jpipe, j, js), lambda: case(fpca, ppipe, p, ps))
    # a fan-out of one spec under two ADCs: one stacked launch would serve
    # the wrong epilogue for one of them
    for mod, pipe, s in ((jfpca, j, js), (fpca, p, ps)):
        pipe.register("adc3", mod.FPCAProgram(spec=s["dense"], adc=mod.ADCConfig(bits=3)), _kernel(4))
    same_error(lambda: j.run_config_batch(["dense", "adc3"], zero[None]),
                lambda: p.run_config_batch(["dense", "adc3"], zero[None]))
    # a plain calibration is a default-circuit one: a custom circuit refuses it
    jj = jpipe.FPCAPipeline(jm[75], backend="basis")
    pp = ppipe.FPCAPipeline(pm[75], backend="basis", device="cpu")
    jj.register("c", jfpca.FPCAProgram(spec=js["dense"], circuit=JCircuit(drive_c=0.30)), _kernel(0))
    pp.register("c", fpca.FPCAProgram(spec=ps["dense"], circuit=CircuitParams(drive_c=0.30)), _kernel(0))
    same_error(lambda: jj.serve([jpipe.FrontendRequest("c", zero)]),
                lambda: pp.serve([ppipe.FrontendRequest("c", zero)]))
    assert issubclass(ppipe.CalibrationKeyError, ValueError)
    with pytest.raises(ValueError, match="bucket_patience"):
        ppipe.FPCAPipeline(pm, device="cpu", bucket_patience=0)


def test_deprecation_shims_and_device(models, heads):
    _, p = _pair(models, heads)
    mix = _mix(4, seed=10, names=("dense", "binned"))
    with pytest.warns(DeprecationWarning, match="submit is deprecated"):
        old = p.submit(_requests(ppipe, mix))
    for a, b in zip(old, p.serve(_requests(ppipe, mix))):
        assert torch.equal(a, b)
    with pytest.warns(DeprecationWarning, match="FrontendConfig is deprecated"):
        assert ppipe.FrontendConfig is fpca.ProgrammedConfig
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ppipe.PipelineStats is not None
    assert p.backend == "basis" and p.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ppipe.FPCAPipeline(models[1])


@pytest.mark.parametrize("cross", [False, True])
def test_pipeline_data_parallel_mesh(models, heads, cross):
    """Batches shard over a one-rank host mesh's data axes: the mix served
    with ``mesh=`` equals the unmeshed pipeline bit for bit (frontends,
    models, masked requests, merged groups), and the reference's meshed
    pipeline within the counts tolerance."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    j, plain = _pair(models, heads, cross_config_batching=cross)
    meshed = ppipe.FPCAPipeline(models[1], backend="basis", device="cpu", mesh=mesh, cross_config_batching=cross)
    _register(meshed, fpca, heads)
    j_meshed = jpipe.FPCAPipeline(models[0], backend="basis", mesh=j_host_mesh(1, 1), cross_config_batching=cross)
    _register(j_meshed, jfpca, heads, models_too=False)
    mix = _mix(16, seed=7)
    got, want = meshed.serve(_requests(ppipe, mix)), plain.serve(_requests(ppipe, mix))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_raw(g), _raw(w))
    assert {k: getattr(meshed.stats, k) for k in STATS} == {k: getattr(plain.stats, k) for k in STATS}
    assert all(h.data_parallelism == 1 and h.mesh is mesh for h in meshed._handles.values())
    frontends = [(n, i, m) for n, i, m in mix if n in ("dense", "dense_b", "overlap", "binned")]
    ref = j_meshed.serve(_requests(jpipe, frontends))
    port = meshed.serve(_requests(ppipe, frontends))
    counts_close(np.concatenate([_raw(x).ravel() for x in port]), np.concatenate([_raw(x).ravel() for x in ref]))


def test_compile_takes_a_mesh(models, heads):
    """``fpca.compile(mesh=)`` on a model program: dense, region-skip and
    odd-batch calls equal the unmeshed handle's bit for bit; a mesh on
    another device type is refused."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    prog = _models(fpca, _specs(fpca)["dense"])["cnn"]
    hp = head_params_from_numpy(heads["cnn"], device="cpu")
    kw = dict(backend="basis", device="cpu", weights=_kernel(12), head_params=hp, model=models[1][75])
    a, b = fpca.compile(prog, mesh=mesh, **kw), fpca.compile(prog, **kw)
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    spec = prog.spec
    mask = rng.random((3, -(-spec.eff_h // spec.skip_block), -(-spec.eff_w // spec.skip_block))) < 0.4
    assert torch.equal(a.run(frames), b.run(frames))
    assert torch.equal(a.run(frames, block_mask=mask), b.run(frames, block_mask=mask))
    assert a.data_parallelism == 1 and a._padded_batch(3) == 4
    with pytest.raises(ValueError, match="mesh is on 'cpu' devices"):
        fpca.CompiledFrontend(prog.frontend, backend=a.backend, model=a.model, device=torch.device("meta"), mesh=mesh)
