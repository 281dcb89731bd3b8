"""The port's compile/execute API and the whole slice against the reference:
``FPCAModelProgram`` -> ``compile`` -> ``CompiledModel.run``, dense and with
region skipping, on the same numpy inputs and handed-over parameters.

Tolerances, each with its reason:

* signatures — byte-equal (the executable-cache key contract);
* head on shared counts — ``rtol=1e-5`` (float32 products summed in another
  order), with an absolute floor of 1e-5 of the largest logit for entries
  that cancel to near zero;
* counts — at most 1 ADC count and fewer than 5% off (round-half flips);
* end-to-end logits — bounded by how far those count flips can move them
  through the head, ``|Δlogits| <= |W2|^T |W1|^T |Δcounts| * input_scale``
  (relu is 1-Lipschitz), and the same top-1 class wherever the reference's
  margin exceeds twice that bound.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import counts_close
from repro.configs import fpca_cnn as j_fpca_cnn
from repro.core.mapping import FPCASpec as JFPCASpec
from repro.core.mapping import active_window_mask as j_active_window_mask
from repro_torch import fpca
from repro_torch.configs import fpca_cnn
from repro_torch.core.mapping import active_window_mask
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy, tensor_from_numpy
from repro_torch.device import resolve_device

CPU = torch.device("cpu")
SMALL = dict(image_h=24, image_w=24, out_channels=4, kernel=3, stride=2)


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


def _pair(mod, spec_kw: dict, head: list, frontend_kw: dict | None = None, **kw):
    """The same model program built in the reference (``mod = jfpca``) or
    the port (``mod = fpca``)."""
    spec = (JFPCASpec if mod is jfpca else fpca.FPCASpec)(**spec_kw)
    fkw = {}
    for k, (cls, args) in (frontend_kw or {}).items():
        fkw[k] = getattr(mod, cls)(**args)
    layers = tuple(getattr(mod, cls)(*args, **lkw) for cls, args, lkw in head)
    return mod.FPCAModelProgram(frontend=mod.FPCAProgram(spec=spec, **fkw), head=layers, **kw)


DENSE_HEAD = [("DenseSpec", (8,), {"activation": "relu"}), ("DenseSpec", (3,), {})]
CONV_HEAD = [
    ("ConvSpec", (6, 3), {"activation": "relu"}),
    ("PoolSpec", (2,), {}),
    ("ActivationSpec", ("tanh",), {}),
    ("DenseSpec", (3,), {}),
]
SAME_HEAD = [
    ("ConvSpec", (5, 3), {"stride": 2, "padding": "SAME", "activation": "silu"}),
    ("PoolSpec", (2,), {"stride": 1, "kind": "avg"}),
    ("DenseSpec", (7,), {"activation": "gelu"}),
    ("DenseSpec", (2,), {}),
]

PROGRAMS = [
    (SMALL, DENSE_HEAD, None, {}),
    (SMALL, CONV_HEAD, {"adc": ("ADCConfig", {"bits": 6})}, {"input_scale": 0.25}),
    (dict(SMALL, stride=1, padding=1), SAME_HEAD,
     {"enc": ("WeightEncoding", {"n_levels": 8, "w_scale": 0.5}),
      "circuit": ("CircuitParams", {"r_metal_mm": 2.0})}, {"input_scale": 0.125}),
]


@pytest.mark.parametrize("spec_kw,head,frontend_kw,kw", PROGRAMS)
def test_signatures_byte_equal(spec_kw, head, frontend_kw, kw):
    jp = _pair(jfpca, spec_kw, head, frontend_kw, **kw)
    pp = _pair(fpca, spec_kw, head, frontend_kw, **kw)
    assert repr(pp.signature()) == repr(jp.signature())
    assert repr(pp.frontend.signature()) == repr(jp.frontend.signature())
    f = pp.frontend
    assert repr(fpca.spec_signature(f.spec, f.out_channels, f.adc, f.enc)) == repr(
        jfpca.spec_signature(jp.frontend.spec, jp.frontend.out_channels, jp.frontend.adc,
                             jp.frontend.enc))
    assert pp.head_shapes() == jp.head_shapes()


def test_fpca_cnn_config_matches_reference():
    """The shipped model at full width: 24x24x8 = 4608 features -> 64 -> 2."""
    pp, jp = fpca_cnn.make_model_program(), j_fpca_cnn.make_model_program()
    assert repr(pp.signature()) == repr(jp.signature())
    assert pp.head_shapes() == [(24, 24, 8), (64,), (2,)]
    assert fpca_cnn.CFG["hidden"] == 64 and fpca_cnn.FRONTEND_SPEC.n_active_pixels == 75


def test_program_validation_and_later_slices():
    fe = fpca.FPCAProgram(spec=fpca.FPCASpec(**SMALL))
    with pytest.raises(ValueError, match="at least one layer"):
        fpca.FPCAModelProgram(frontend=fe, head=())
    with pytest.raises(ValueError, match="last head stage"):
        fpca.FPCAModelProgram(frontend=fe, head=(fpca.ActivationSpec("relu"),))
    with pytest.raises(ValueError, match="conv kernel"):
        fpca.FPCAModelProgram(frontend=fe, head=(fpca.ConvSpec(4, 12), fpca.DenseSpec(2)))
    with pytest.raises(ValueError, match="spatial"):
        fpca.FPCAModelProgram(frontend=fe, head=(fpca.DenseSpec(8), fpca.PoolSpec(1), fpca.DenseSpec(2)))
    with pytest.raises(ValueError, match="unknown activation"):
        fpca.DenseSpec(4, activation="softmax3")
    with pytest.raises(ValueError, match="input_scale"):
        fpca.FPCAModelProgram(frontend=fe, head=(fpca.DenseSpec(2),), input_scale=0.0)
    with pytest.raises(ValueError, match="unknown precision 'fp4'"):
        fpca.FPCAModelProgram(frontend=fe, head=(fpca.DenseSpec(2),), precision="fp4")
    with pytest.raises(TypeError, match="not iterable"):
        fpca.FPCAModelProgram(frontend=fe, head=object())
    with pytest.raises(ValueError, match="target"):
        fpca.GateControllerConfig(target=0.0)
    with pytest.raises(TypeError, match="gate"):
        fpca.FPCAProgram(spec=fe.spec, gate=0.1)


@pytest.mark.parametrize("spec_kw,head,frontend_kw,kw", PROGRAMS)
def test_head_matches_reference_on_shared_counts(spec_kw, head, frontend_kw, kw):
    jp = _pair(jfpca, spec_kw, head, frontend_kw, **kw)
    pp = _pair(fpca, spec_kw, head, frontend_kw, **kw)
    jparams = jp.init_head(jax.random.PRNGKey(3))
    params = pp.bind_head_params(head_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams], device="cpu"))
    counts = np.random.default_rng(4).integers(0, 64, (3, *jp.frontend.out_shape)).astype(np.float32)
    want = np.asarray(jp.apply_head(jparams, counts))
    got = pp.apply_head(params, torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="parameter shapes"):
        pp.bind_head_params([{"w": torch.zeros(2, 2), "b": torch.zeros(2)}] + params[1:])


def _logits_close(got, want, counts_diff, head, scale) -> None:
    bound = (np.abs(counts_diff).reshape(len(want), -1) * scale) @ np.abs(head[0]["w"])
    bound = bound @ np.abs(head[1]["w"]) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound)
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * bound.max(axis=1)
    np.testing.assert_array_equal(got.argmax(1)[decided], want.argmax(1)[decided])


@pytest.fixture(scope="module")
def slice_case(bucket_model):
    """The reference's side of the whole-slice comparison, computed once."""
    rng = np.random.default_rng(5)
    jp = _pair(jfpca, SMALL, DENSE_HEAD, input_scale=0.125)
    images = rng.uniform(0, 1, (3, 24, 24, 3)).astype(np.float32)
    kern = (rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(np.float32)
    bn = rng.integers(0, 16, 4).astype(np.float32)
    block = rng.random((3, 3)) < 0.4
    jhead = [{k: np.asarray(v) for k, v in p.items()} for p in jp.init_head(jax.random.PRNGKey(6))]
    jm = jfpca.compile(jp, backend="basis", weights=kern, bn_offset=bn, head_params=jhead,
                       model=bucket_model)
    keep = np.broadcast_to(j_active_window_mask(jp.spec, block), (3, 10, 10))
    out = {
        "counts": np.asarray(jm.run_frontend_weighted(jm.kernel, jm.bn_offset, images)),
        "logits": np.asarray(jm.run(images)),
        "masked_counts": np.asarray(jm.run_frontend_weighted(jm.kernel, jm.bn_offset, images,
                                                             np.array(keep))),
        "masked_logits": np.asarray(jm.run(images, block_mask=block)),
        "skipped_logits": np.asarray(jm.run(images, block_mask=np.zeros((3, 3), bool))),
    }
    stats = {f: getattr(jm.stats, f) for f in
             ("runs", "windows_total", "windows_executed", "launches_skipped", "bucket_switches")}
    return dict(images=images, kern=kern, bn=bn, block=block, head=jhead, stats=stats, **out)


@pytest.mark.parametrize("backend", ["basis", "cuda", "reference"])
def test_whole_slice_matches_reference(slice_case, port_model, backend):
    """compile(model, device="cpu") on each backend against the reference's
    compile(model, backend="basis"): frontend counts, logits, region skipping
    and the all-skipped short-circuit, and the same serving stats."""
    c = slice_case
    pp = _pair(fpca, SMALL, DENSE_HEAD, input_scale=0.125)
    m = fpca.compile(pp, backend=backend, device="cpu", weights=c["kern"], bn_offset=c["bn"],
                     head_params=head_params_from_numpy(c["head"], device="cpu"), model=port_model)
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, c["images"]).numpy()
    counts_close(counts, c["counts"])
    logits = m.run(c["images"]).numpy()
    assert logits.shape == (3, 3)
    _logits_close(logits, c["logits"], counts - c["counts"], c["head"], 0.125)
    keep = np.broadcast_to(active_window_mask(m.spec, c["block"]), (3, 10, 10))
    masked = m.run_frontend_weighted(m.kernel, m.bn_offset, c["images"], keep).numpy()
    counts_close(masked, c["masked_counts"])
    np.testing.assert_array_equal(masked, counts * keep[..., None])       # in-port: exact
    logits_m = m.run(c["images"], block_mask=c["block"]).numpy()
    _logits_close(logits_m, c["masked_logits"], masked - c["masked_counts"], c["head"], 0.125)
    np.testing.assert_array_equal(logits_m, m.head_logits(torch.from_numpy(masked)).numpy())
    skipped = m.run(c["images"], block_mask=np.zeros((3, 3), bool)).numpy()
    np.testing.assert_allclose(skipped, c["skipped_logits"], rtol=1e-5, atol=1e-6)
    assert {f: getattr(m.stats, f) for f in c["stats"]} == c["stats"]
    single = m.run(c["images"][0]).numpy()
    assert single.shape == (3,)


def test_full_width_fpca_cnn_on_host_matches_reference(bucket_model, port_model):
    """One 120x120x3 frame through the shipped fpca_cnn at full width."""
    rng = np.random.default_rng(7)
    jp, pp = j_fpca_cnn.make_model_program(), fpca_cnn.make_model_program()
    frame = rng.uniform(0, 1, (1, 120, 120, 3)).astype(np.float32)
    kern = (rng.normal(size=(8, 5, 5, 3)) * 0.3).astype(np.float32)
    jhead = [{k: np.asarray(v) for k, v in p.items()} for p in jp.init_head(jax.random.PRNGKey(8))]
    jm = jfpca.compile(jp, backend="basis", weights=kern, head_params=jhead, model=bucket_model)
    m = fpca.compile(pp, device="cpu", weights=kern,
                     head_params=head_params_from_numpy(jhead, device="cpu"), model=port_model)
    assert m.backend.name == "basis"
    want_c = np.asarray(jm.run_frontend_weighted(jm.kernel, jm.bn_offset, frame))
    got_c = m.run_frontend_weighted(m.kernel, m.bn_offset, frame).numpy()
    assert got_c.shape == (1, 24, 24, 8)
    counts_close(got_c, want_c)
    _logits_close(m.run(frame).numpy(), np.asarray(jm.run(frame)), got_c - want_c, jhead, 1.0)


def test_reprogram_builds_no_executable(port_model):
    rng = np.random.default_rng(9)
    pp = _pair(fpca, SMALL, DENSE_HEAD)
    images = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    m = fpca.compile(pp, device="cpu", weights=rng.normal(size=(4, 3, 3, 3)) * 0.3,
                     head_params=pp.init_head(gen, device="cpu"), model=port_model)
    block = np.zeros((3, 3), bool)
    block[1, 1] = True
    first = (m.run(images), m.run(images, block_mask=block))
    misses = m.cache_info().misses
    m.reprogram(rng.normal(size=(4, 3, 3, 3)) * 0.3, bn_offset=np.full(4, 5.0))
    m.reprogram(head_params=pp.init_head(gen, device="cpu"))
    m.reprogram(bn_offset=np.zeros(4))
    second = (m.run(images), m.run(images, block_mask=block))
    info = m.cache_info()
    assert info.misses == misses and info.hits >= 2
    assert not torch.equal(first[0], second[0])
    assert m.stats.reprograms == 5
    with pytest.raises(ValueError, match="kernel shape"):
        m.reprogram(np.zeros((4, 5, 5, 3)))
    with pytest.raises(ValueError, match="reprogram needs"):
        m.reprogram()


def test_run_validation(port_model):
    pp = _pair(fpca, SMALL, DENSE_HEAD)
    m = fpca.compile(pp, device="cpu", model=port_model)
    images = np.zeros((1, 24, 24, 3), np.float32)
    with pytest.raises(RuntimeError, match="no weights"):
        m.run(images)
    m.reprogram(np.zeros((4, 3, 3, 3)))
    with pytest.raises(RuntimeError, match="no head parameters"):
        m.run(images)
    m.reprogram(head_params=pp.init_head(torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="expected"):
        m.run(np.zeros((1, 20, 24, 3), np.float32))
    with pytest.raises(ValueError, match="not both"):
        m.run(images, block_mask=np.ones((3, 3), bool), window_keep=np.ones((1, 10, 10), bool))
    with pytest.raises(ValueError, match="head_params= needs"):
        fpca.compile(pp.frontend, device="cpu", model=port_model, head_params=[])


def test_backend_registry():
    assert fpca.available_backends() == ("cuda", "basis", "reference")
    assert fpca.default_backend_name(torch.device("cuda")) == "cuda"
    assert fpca.default_backend_name(CPU) == "basis"
    with pytest.raises(ValueError, match="available"):
        fpca.get_backend("pallas")
    with pytest.raises(ValueError, match="already registered"):
        fpca.register_backend("cuda")(lambda *a, **k: None)


def test_executable_cache_lru():
    cache = fpca.ExecutableCache(2)
    for key in ("a", "b", "a", "c"):
        cache.get((key,), lambda: object())
    info = cache.info(verbose=True)
    assert (info.hits, info.misses, info.evictions, info.currsize) == (1, 3, 1, 2)
    assert info.eviction_log == (("b",),) and info.resident == (("a",), ("c",))


def test_compile_without_device_raises_on_a_host_without_gpu(monkeypatch, port_model):
    """No silent fallback: with no card and no device=, compile() raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = _pair(fpca, SMALL, DENSE_HEAD)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fpca.compile(pp, model=port_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensor_from_numpy(np.ones(2))
    assert tensor_from_numpy(np.ones(2), device="cpu").dtype == torch.float32


def test_port_imports_neither_jax_nor_the_reference():
    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)(?!_torch))",
                         re.MULTILINE)
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    assert pattern.search("import jax.numpy as jnp") and pattern.search("from repro.core import x")
    assert not pattern.search("from repro_torch.core import x")
