"""The port's model zoo and graph heads against the reference: the registry,
``HeadGraph`` validation, signatures, graph-head numerics, ``Detections``,
the patched heads and the handle's new surface, on 20x20 frames (a 4x4
window grid) with the reference's parameters handed over as numpy.

Tolerances, each with its reason:

* signatures and error messages — equal (the cache-key contract; the
  reference's tests match on the messages);
* graph head on shared counts — ``rtol=1e-5`` (float32 products summed in
  another order), with an absolute floor of 1e-5 of the largest output for
  entries that cancel to near zero;
* counts — at most 1 ADC count and fewer than 5% off (round-half flips);
* within the port — bit for bit: ``run`` against head(frontend counts),
  ``fused_patched_logits`` against ``patched_logits`` row by row.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import same_error
from repro.configs import fpca_cnn as j_fpca_cnn
from repro.core.mapping import FPCASpec as JFPCASpec
from repro.fpca import zoo as jzoo
from repro.models import heads as jheads
from repro_torch import fpca
from repro_torch.configs import fpca_cnn
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy
from repro_torch.core.mapping import active_window_mask
from repro_torch.fpca import zoo
from repro_torch.models import heads

H = W = 20

# equal to tests/test_zoo.py's GOLDEN_CNN_SIG (the reference's pin)
GOLDEN_CNN_SIG = (
    "repro.fpca.model/1",
    "repro.fpca/1",
    ("spec", 20, 20, 3, 5, 5, 5, 3, 0, 1, 8),
    ("out_channels", 3),
    ("adc", 8, 1.0),
    ("enc", 16, 1.0),
    ("circuit", ("v_sat", 1.0), ("s0", 0.37), ("drive_a", 0.15),
     ("drive_b", -0.1), ("drive_c", 0.25), ("coupling", 0.15),
     ("kappa_r", 0.012), ("r_metal_mm", 0.0), ("fp_iters", 8.0)),
    ("head", ("dense", 64, "relu"), ("dense", 2, "")),
    ("input_scale", 1.0),
)


def _spec(mod, c_o: int = 3):
    cls = JFPCASpec if mod is jfpca else fpca.FPCASpec
    return cls(image_h=H, image_w=W, out_channels=c_o, kernel=5, stride=5)


def _kernel(seed: int = 0, c_o: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c_o, 5, 5, 3)) * 0.2).astype(np.float32)


def _frames(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, H, W, 3)).astype(np.float32)


def _numpy_tree(params) -> dict:
    return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}


def _concat_graph(mod):
    """A two-branch graph with a channel concat (not a zoo arch)."""
    return mod.HeadGraph(
        nodes=(
            mod.Node("a", mod.ConvSpec(4, 3, padding="SAME")),
            mod.Node("b", mod.ConvSpec(2, 1, activation="tanh")),
            mod.Node("cat", mod.ConcatSpec(activation="relu"), ("a", "b")),
            mod.Node("pool", mod.PoolSpec(2, stride=1, kind="max"), ("cat",)),
            mod.Node("out", mod.DenseSpec(5), ("pool",)),
        ),
        output="out",
    )


def _model(mod, arch: str, **kw):
    if arch == "concat":
        return mod.FPCAModelProgram(frontend=mod.FPCAProgram(spec=_spec(mod)), head=_concat_graph(mod),
                                    input_scale=0.25)
    build = jzoo.build_model if mod is jfpca else zoo.build_model
    return build({"arch": arch, "spec": _spec(mod), **kw})


SMALL_ARCHS = {
    "fpca_resnet": {"width": 4, "hidden": 8, "n_classes": 3},
    "fpca_detect": {"width": 4, "n_classes": 3},
    "concat": {},
}


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_round_trip():
    assert zoo.available_archs() == ("fpca_cnn", "fpca_detect", "fpca_resnet")
    assert fpca.available_archs() == zoo.available_archs()

    @zoo.register_arch("zoo_test_arch")
    def _build(cfg):
        return zoo._ARCHS["fpca_cnn"](cfg)

    try:
        model = zoo.build_model({"arch": "zoo_test_arch", "spec": _spec(fpca)})
        assert model.arch == "zoo_test_arch" and not model.is_graph_head
        assert "zoo_test_arch" in zoo.available_archs()

        @zoo.register_arch("zoo_test_arch", overwrite=True)
        def _build2(cfg):
            return zoo._ARCHS["fpca_resnet"](cfg)

        model2 = fpca.build_model({"arch": "fpca_cnn"}, arch="zoo_test_arch", spec=_spec(fpca))
        assert model2.is_graph_head and model2.arch == "zoo_test_arch"
    finally:
        zoo._ARCHS.pop("zoo_test_arch", None)
    default = zoo.build_model({"arch": "fpca_resnet"})
    assert default.spec == fpca_cnn.FRONTEND_SPEC and default.frontend.out_shape == (24, 24, 8)


@pytest.mark.parametrize("case", ["duplicate", "empty_name", "unknown", "no_arch"])
def test_registry_errors_match_reference(case):
    def call(mod):
        z = jzoo if mod is jfpca else zoo
        if case == "duplicate":
            z.register_arch("fpca_cnn")(lambda cfg: None)
        elif case == "empty_name":
            z.register_arch("")
        elif case == "unknown":
            z.build_model({"arch": "nope"})
        else:
            z.build_model({"spec": _spec(mod)})

    same_error(lambda: call(jfpca), lambda: call(fpca))


# ---------------------------------------------------------------------------
# fpca_cnn: the config module's signature, shared executables
# ---------------------------------------------------------------------------


def test_fpca_cnn_signature_golden():
    model = zoo.build_model({"arch": "fpca_cnn", "spec": _spec(fpca)})
    assert model.signature() == GOLDEN_CNN_SIG
    assert repr(model.signature()) == repr(jzoo.build_model({"arch": "fpca_cnn", "spec": _spec(jfpca)}).signature())
    assert model.arch == "fpca_cnn"
    full = fpca_cnn.build()
    assert full.signature() == fpca_cnn.make_model_program().signature()
    assert repr(full.signature()) == repr(j_fpca_cnn.build().signature())


def test_zoo_fpca_cnn_shares_the_config_modules_executables(port_model):
    spec = _spec(fpca)
    legacy = fpca_cnn.make_model_program(spec)
    built = zoo.build_model({"arch": "fpca_cnn", "spec": spec})
    assert built.signature() == legacy.signature() and built.arch == "fpca_cnn" and legacy.arch is None
    hp = legacy.init_head(torch.Generator().manual_seed(0), device="cpu")
    cache = fpca.ExecutableCache(8)
    images = _frames(2)
    m1 = fpca.compile(legacy, device="cpu", weights=_kernel(), head_params=hp, model=port_model, cache=cache)
    out1 = m1.run(images)
    misses = cache.info().misses
    m2 = fpca.compile(built, device="cpu", weights=_kernel(), head_params=hp, model=port_model, cache=cache)
    torch.testing.assert_close(m2.run(images), out1, rtol=0, atol=0)
    assert cache.info().misses == misses
    assert (m1.arch, m2.arch) == ("custom", "fpca_cnn")


# ---------------------------------------------------------------------------
# HeadGraph validation: every error with the reference's message
# ---------------------------------------------------------------------------


def _invalid(mod, case: str):
    conv = mod.ConvSpec(4, 3, padding="SAME")
    N, G = mod.Node, mod.HeadGraph
    if case == "cycle":
        G(nodes=(N("a", conv, ("b",)), N("b", conv, ("a",)), N("out", mod.DenseSpec(2), ("b",))), output="out")
    elif case == "duplicate":
        G(nodes=(N("a", conv), N("a", conv, ("a",)), N("out", mod.DenseSpec(2), ("a",))), output="out")
    elif case == "reserved":
        G(nodes=(N("input", conv), N("out", mod.DenseSpec(2), ("input",))), output="out")
    elif case == "undefined":
        G(nodes=(N("a", conv, ("ghost",)), N("out", mod.DenseSpec(2), ("a",))), output="out")
    elif case == "missing_output":
        G(nodes=(N("out", mod.DenseSpec(2)),), output="missing")
    elif case == "bad_output":
        G(nodes=(N("a", conv),), output="a")
    elif case == "empty":
        G(nodes=(), output="out")
    elif case == "not_a_node":
        G(nodes=(conv,), output="out")
    elif case == "add_arity":
        N("join", mod.AddSpec(), ("stem",))
    elif case == "concat_arity":
        N("cat", mod.ConcatSpec(), ("stem",))
    elif case == "conv_arity":
        N("c", conv, ("a", "b"))
    elif case == "unknown_op":
        N("c", "conv")
    elif case == "empty_name":
        N("", conv)
    elif case == "detect_classes":
        mod.DetectSpec(0)
    elif case == "detect_kernel":
        mod.DetectSpec(2, kernel=0)
    elif case == "add_activation":
        mod.AddSpec(activation="softmax3")
    elif case == "join_shapes":
        G(nodes=(N("stem", conv), N("branch", mod.ConvSpec(6, 3, padding="SAME"), ("stem",)),
                 N("join", mod.AddSpec(), ("stem", "branch")), N("out", mod.DenseSpec(2), ("join",))),
          output="out").shapes((4, 4, 3))
    elif case == "concat_shapes":
        G(nodes=(N("a", conv), N("b", mod.ConvSpec(4, 3, stride=2, padding="SAME")),
                 N("cat", mod.ConcatSpec(), ("a", "b")), N("out", mod.DenseSpec(2), ("cat",))),
          output="out").shapes((4, 4, 3))
    elif case in ("conv_spatial", "detect_spatial", "pool_spatial"):
        op = {"conv_spatial": conv, "detect_spatial": mod.DetectSpec(2), "pool_spatial": mod.PoolSpec(2)}[case]
        G(nodes=(N("d", mod.DenseSpec(8)), N("x", op, ("d",)), N("out", mod.DenseSpec(2), ("x",))),
          output="out").shapes((4, 4, 3))
    elif case == "conv_kernel":
        G(nodes=(N("c", mod.ConvSpec(4, 5)), N("out", mod.DenseSpec(2), ("c",))), output="out").shapes((4, 4, 3))
    elif case == "pool_size":
        G(nodes=(N("p", mod.PoolSpec(5)), N("out", mod.DenseSpec(2), ("p",))), output="out").shapes((4, 4, 3))
    elif case == "model_geometry":
        mod.FPCAModelProgram(
            frontend=mod.FPCAProgram(spec=_spec(mod)),
            head=G(nodes=(N("c", mod.ConvSpec(4, 7)), N("out", mod.DenseSpec(2), ("c",))), output="out"))
    elif case == "model_input_scale":
        mod.FPCAModelProgram(frontend=mod.FPCAProgram(spec=_spec(mod)), head=_concat_graph(mod), input_scale=0.0)
    elif case == "head_shapes":
        _model(mod, "fpca_resnet").head_shapes()
    else:
        raise AssertionError(case)


INVALID = ["cycle", "duplicate", "reserved", "undefined", "missing_output", "bad_output", "empty", "not_a_node",
           "add_arity", "concat_arity", "conv_arity", "unknown_op", "empty_name", "detect_classes",
           "detect_kernel", "add_activation", "join_shapes", "concat_shapes", "conv_spatial", "detect_spatial",
           "pool_spatial", "conv_kernel", "pool_size", "model_geometry", "model_input_scale", "head_shapes"]


@pytest.mark.parametrize("case", INVALID)
def test_head_graph_errors_match_reference(case):
    same_error(lambda: _invalid(jfpca, case), lambda: _invalid(fpca, case))


@pytest.mark.parametrize("case", ["missing_node", "bad_shape", "not_a_dict"])
def test_graph_param_binding_errors_match_reference(case):
    jm, pm = _model(jfpca, "fpca_resnet"), _model(fpca, "fpca_resnet")
    params = _numpy_tree(jm.init_head(jax.random.PRNGKey(0)))

    def bad():
        p = dict(params)
        if case == "missing_node":
            p.pop("logits")
        elif case == "bad_shape":
            p["fc"] = {"w": np.zeros((3, 3), np.float32), "b": np.zeros((3,), np.float32)}
        else:
            p = list(p.values())
        return p

    same_error(lambda: jm.bind_head_params(bad()), lambda: pm.bind_head_params(bad(), device="cpu"))


# ---------------------------------------------------------------------------
# signatures, geometry and graph-head numerics against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["fpca_resnet", "fpca_detect", "concat"])
def test_graph_signatures_byte_equal(arch):
    jm, pm = _model(jfpca, arch, **SMALL_ARCHS[arch]), _model(fpca, arch, **SMALL_ARCHS[arch])
    assert repr(pm.signature()) == repr(jm.signature())
    assert pm.head.shapes(pm.frontend.out_shape) == jm.head.shapes(jm.frontend.out_shape)
    assert pm.head_out_shape == jm.head_out_shape
    assert (pm.output_kind, pm.n_classes, pm.detect_classes) == (jm.output_kind, jm.n_classes, jm.detect_classes)
    assert [n.name for n in pm.head.toposort()] == [n.name for n in jm.head.toposort()]
    assert pm.replace(arch="other").signature() == pm.signature()
    if arch != "concat":     # the zoo's defaults, at full width
        full = zoo.build_model({"arch": arch})
        assert repr(full.signature()) == repr(jzoo.build_model({"arch": arch}).signature())


@pytest.mark.parametrize("arch", ["fpca_resnet", "fpca_detect", "concat"])
def test_graph_head_matches_reference_on_shared_counts(arch):
    jm, pm = _model(jfpca, arch, **SMALL_ARCHS[arch]), _model(fpca, arch, **SMALL_ARCHS[arch])
    jparams = jm.init_head(jax.random.PRNGKey(3))
    params = pm.bind_head_params(head_params_from_numpy(_numpy_tree(jparams), device="cpu"))
    counts = np.random.default_rng(4).integers(0, 64, (3, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jm.apply_head(jparams, counts))
    got = pm.apply_head(params, torch.from_numpy(counts)).numpy()
    assert got.shape == want.shape == (3,) + pm.head_out_shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    single = pm.head.apply(params, torch.from_numpy(counts[0]) * pm.input_scale).numpy()
    np.testing.assert_allclose(single, want[0], rtol=1e-5, atol=1e-5 * np.abs(want).max())
    fresh = pm.init_head(torch.Generator().manual_seed(0), device="cpu")
    assert {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in fresh.items()} == \
        {n: {k: v.shape for k, v in p.items()} for n, p in _numpy_tree(jparams).items()}


# ---------------------------------------------------------------------------
# serving: counts, run == head(frontend), Detections, patched heads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(bucket_model):
    """The reference's side of the serving comparison, computed once."""
    out = {}
    frames = _frames(3, seed=3)
    block = np.zeros((1, 1), bool)
    for arch in ("fpca_resnet", "fpca_detect"):
        jm = _model(jfpca, arch, **SMALL_ARCHS[arch])
        hp = _numpy_tree(jm.init_head(jax.random.PRNGKey(1)))
        m = jfpca.compile(jm, backend="basis", weights=_kernel(2), head_params=hp, model=bucket_model)
        counts = np.asarray(m.run_frontend_weighted(m.kernel, m.bn_offset, frames))
        res = m.run(frames)
        raw = np.concatenate([np.asarray(res.scores), np.asarray(res.boxes)], -1) if arch == "fpca_detect" \
            else np.asarray(res)
        prev = np.random.default_rng(5).integers(0, 32, counts.shape).astype(np.float32)
        keep = np.random.default_rng(6).random(counts.shape[:3]) < 0.5
        logits_p, eff_p = m.patched_logits(counts, prev, keep)
        out[arch] = dict(hp=hp, counts=counts, raw=raw, prev=prev, keep=keep,
                         patched=np.asarray(logits_p), eff=np.asarray(eff_p))
    out["frames"] = frames
    out["block"] = block
    return out


@pytest.mark.parametrize("backend", ["basis", "cuda", "reference"])
@pytest.mark.parametrize("arch", ["fpca_resnet", "fpca_detect"])
def test_graph_model_serves_like_the_reference(served, port_model, arch, backend):
    c, frames = served[arch], served["frames"]
    pm = _model(fpca, arch, **SMALL_ARCHS[arch])
    m = fpca.compile(pm, backend=backend, device="cpu", weights=_kernel(2),
                     head_params=head_params_from_numpy(c["hp"], device="cpu"), model=port_model)
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, frames)
    diff = np.abs(counts.numpy() - c["counts"])
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.05
    raw = m.run_weighted(m.kernel, m.bn_offset, frames)
    torch.testing.assert_close(raw, m.head_logits(counts), rtol=0, atol=0)      # in-port: exact
    out = m.run(frames)
    if arch == "fpca_detect":
        assert isinstance(out, fpca.Detections)
        assert tuple(out.scores.shape) == (3, 4, 4, 3) and tuple(out.boxes.shape) == (3, 4, 4, 4)
        assert out.grid_shape == (4, 4) and out.n_classes == 3
        torch.testing.assert_close(torch.cat([out.scores, out.boxes], -1), raw, rtol=0, atol=0)
    else:
        assert tuple(out.shape) == (3, 3)
        torch.testing.assert_close(out, raw, rtol=0, atol=0)
    # the head on the reference's own counts gives the reference's outputs
    np.testing.assert_allclose(m.head_logits(c["counts"].copy()).numpy(), c["raw"], rtol=1e-5,
                               atol=1e-5 * np.abs(c["raw"]).max())
    # region skip: compacted == masked dense, all-skipped serves the head on zeros
    block = np.zeros((3, 3), bool)         # 8-pixel skip blocks over 20x20
    block[1:, :2] = True
    keep = np.broadcast_to(active_window_mask(m.spec, block), (3, 4, 4))
    assert 0 < keep[0].sum() < 16
    masked = m.run_frontend_weighted(m.kernel, m.bn_offset, frames, keep)
    torch.testing.assert_close(masked, counts * torch.from_numpy(keep.copy())[..., None], rtol=0, atol=0)
    torch.testing.assert_close(m.run_weighted(m.kernel, m.bn_offset, frames, keep), m.head_logits(masked),
                               rtol=0, atol=0)
    skipped = m.run_weighted(m.kernel, m.bn_offset, frames, np.zeros((3, 4, 4), bool))
    torch.testing.assert_close(skipped, m.head_logits(torch.zeros_like(counts)), rtol=0, atol=0)


def test_detections_match_reference_on_the_same_raw_map(served):
    raw = served["fpca_detect"]["raw"]
    want = jheads.Detections.from_raw(raw, 3)
    got = heads.Detections.from_raw(torch.from_numpy(raw), 3)
    np.testing.assert_array_equal(got.class_map(), want.class_map())
    assert got.n_classes == want.n_classes and got.grid_shape == want.grid_shape
    one_j = jheads.Detections(want.scores[1], want.boxes[1])
    one_p = heads.Detections(got.scores[1], got.boxes[1])
    assert one_p.top_k(5) == one_j.top_k(5)
    assert one_p.top_k(100) == one_j.top_k(100)
    same_error(lambda: want.top_k(3), lambda: got.top_k(3))
    same_error(lambda: jheads.Detections.from_raw(raw, 4), lambda: heads.Detections.from_raw(torch.from_numpy(raw), 4))


@pytest.mark.parametrize("arch", ["fpca_resnet", "fpca_detect"])
def test_patched_logits_match_reference_and_fused_rows_are_exact(served, port_model, arch):
    c = served[arch]
    pm = _model(fpca, arch, **SMALL_ARCHS[arch])
    hp = head_params_from_numpy(c["hp"], device="cpu")
    m = fpca.compile(pm, device="cpu", weights=_kernel(2), head_params=hp, model=port_model)
    logits, eff = m.patched_logits(c["counts"], c["prev"], c["keep"])
    np.testing.assert_array_equal(eff.numpy(), c["eff"])
    np.testing.assert_allclose(logits.numpy(), c["patched"], rtol=1e-5, atol=1e-5 * np.abs(c["patched"]).max())
    # fused: each row binds its own head parameters
    hp_b = pm.bind_head_params(pm.init_head(torch.Generator().manual_seed(9), device="cpu"))
    rows = [hp, hp_b, hp]
    stacked = {n: {k: torch.stack([r[n][k] for r in rows]) for k in hp[n]} for n in hp}
    fused, fused_eff = m.fused_patched_logits(stacked, c["counts"], c["prev"], c["keep"])
    torch.testing.assert_close(fused_eff, eff, rtol=0, atol=0)
    for i, r in enumerate(rows):
        want_i, _ = m.patched_logits(c["counts"][i:i + 1], c["prev"][i:i + 1], c["keep"][i:i + 1], r)
        torch.testing.assert_close(fused[i], want_i[0], rtol=0, atol=0)


def test_handle_surface_and_programmed_model(port_model):
    pm = _model(fpca, "fpca_detect", **SMALL_ARCHS["fpca_detect"])
    hp = pm.init_head(torch.Generator().manual_seed(2), device="cpu")
    m = fpca.compile(pm, device="cpu", weights=_kernel(), head_params=hp, model=port_model)
    assert m.out_shape == (4, 4, 3) == pm.frontend.out_shape
    assert (m.n_classes, m.head_out_shape, m.output_kind, m.detect_classes) == (3, (4, 4, 7), "detections", 3)
    assert m.frontend_signature() == pm.frontend.signature() and m.signature() == pm.signature()
    assert m.arch == "fpca_detect" and set(m.head_params) == {"trunk", "det"}
    frames = _frames(2)
    block = np.zeros((3, 3), bool)
    block[0, 0] = True
    m.run(frames, block_mask=block)
    assert m._sticky
    m.reset_bucket_state()
    assert not m._sticky and m.stats.runs == 1
    misses = m.cache_info().misses
    m.reprogram(head_params=pm.init_head(torch.Generator().manual_seed(3), device="cpu"))
    m.run(frames, block_mask=block)
    assert m.cache_info().misses == misses
    fe = fpca.FPCAProgram(spec=_spec(fpca))
    assert fe.replace(out_channels=2).out_shape == (4, 4, 2) and fe.replace().signature() == fe.signature()
    bound = fpca.ProgrammedModel("det", pm, torch.from_numpy(_kernel()), torch.zeros(3), hp)
    assert bound.program is pm.frontend and bound.spec == pm.spec
    assert (bound.out_channels, bound.out_shape) == (3, (4, 4, 3))
