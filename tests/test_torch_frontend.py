"""The port's FPCA training path against the reference, on the CPU: the core
re-exports and small repairs, ``schedule``, ``SyntheticVWW``,
``calibrate_gain``, ``fpca_forward`` in its three modes and through the
fused shim, ``FPCAFrontend`` and its straight-through gradients, and the
training example against its JAX original at smoke size.

Tolerances, each with its reason:

* names, dataclass fields, cycles, synthetic batches, refusals — exact;
* counts — ``counts_close``: at most 1 ADC count on under 5% of counts
  (f32 sums in another order can cross a round-half boundary);
* bitline voltages — 1e-6 V (f32 ``tanh`` and sums of 75 pixels taken in
  another order: a few ulps of a value below 1);
* ``calibrate_gain`` — 1e-5 relative (the f32 oracle feeds a float64 fit);
* activations, gradients, parameters — within 1e-4 of the tensor's max|value|
  (1e-5 for activations, which only scale counts), losses within 1e-5:
  f32 sums through the bucket model and the head taken in another order;
* the same fused counts bit for bit as ``compile(...).run`` (one code path).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fpca as jfpca
from _port_checks import counts_close, same_error
from repro.configs import ARCHS as J_ARCHS
from repro.core import adc as j_adc
from repro.core import curvefit as j_cf
from repro.core import fpca_sim as j_sim
from repro.core import mapping as j_map
from repro.core.device_models import CircuitParams as JCircuitParams
from repro.data.pipeline import SyntheticVWW as JSyntheticVWW
from repro.fpca import backends as j_backends
from repro.fpca import program as j_program
from repro_torch import fpca
from repro_torch import core
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import bucket_model_from_dict, frontend_params_from_numpy, head_params_from_numpy
from repro_torch.core import adc, curvefit, fpca_sim, mapping
from repro_torch.core.device_models import CircuitParams
from repro_torch.data.pipeline import SyntheticVWW
from repro_torch.fpca import backends
from repro_torch.fpca import program

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SPEC_KW = dict(image_h=24, image_w=24, out_channels=4, kernel=5, stride=2)   # 10 x 10 windows, N = 75
MODES = ("oracle", "bucket_hard", "bucket_sigmoid")


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


def _images(b: int, seed: int = 0, hw=(24, 24)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, *hw, 3)).astype(np.float32)


def _kernel(spec_kw: dict, seed: int = 1, scale: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (spec_kw["out_channels"], spec_kw["kernel"], spec_kw["kernel"], 3)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _block_mask(spec: mapping.FPCASpec) -> np.ndarray:
    b = spec.skip_block
    return np.array([[True, False, False], [False, True, False], [False, False, False]])[
        : -(-spec.eff_h // b), : -(-spec.eff_w // b)
    ]


# ---------------------------------------------------------------------------
# C1-C4 and the small names
# ---------------------------------------------------------------------------


def test_core_exports_the_reference_names():
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        if name != "FPCAFrontendConfig":
            assert getattr(core, name) is not None


def test_core_imports_clean_and_the_config_alias_warns_like_the_reference():
    """``import repro_torch.core`` raises nothing under
    ``-W error::DeprecationWarning`` (the alias forwards lazily); touching
    ``FPCAFrontendConfig`` warns with the reference's message and yields the
    program class."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "import repro_torch.core, repro_torch.fpca, repro_torch.core.frontend; print('ok')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
    msgs = []
    for mod in (core, jcore):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            cls = mod.FPCAFrontendConfig
        msgs.append([(w.category, str(w.message)) for w in got])
        assert cls is (fpca.FPCAProgram if mod is core else jfpca.FPCAProgram)
    assert msgs[0] == msgs[1] and msgs[0][0][0] is DeprecationWarning


def test_circuit_params_replace_matches_reference():
    kw = dict(r_metal_mm=2.5, coupling=0.2, fp_iters=5)
    got = CircuitParams().replace(**kw)
    want = JCircuitParams().replace(**kw)
    assert isinstance(got, CircuitParams)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kw", [
    dict(image_h=24, image_w=24, out_channels=4, kernel=5, stride=5),
    dict(image_h=32, image_w=32, out_channels=8, kernel=3, stride=2, max_kernel=3),
    dict(image_h=40, image_w=40, out_channels=16, kernel=5, stride=1, in_channels=1),
])
def test_weights_per_column_matches_reference(kw):
    assert mapping.FPCASpec(**kw).weights_per_column == j_map.FPCASpec(**kw).weights_per_column


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_config_properties_match_reference(arch):
    """Every reference config (dense, moe, ssm, hybrid, encdec, vlm, one
    with a window) carried into the port's ModelConfig field by field."""
    jcfg = J_ARCHS[arch]
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    for prop in ("attn_free", "subquadratic", "has_decode"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()


def test_layer_spec_and_backend_fields_match_reference():
    assert [c.__name__ for c in program.LayerSpec.__args__] == [c.__name__ for c in j_program.LayerSpec.__args__]
    for name, jname in (("reference", "reference"), ("basis", "basis"), ("cuda", "pallas")):
        be, jbe = backends.get_backend(name), j_backends.get_backend(jname)
        assert (be.fused, be.differentiable, be.conv is None) == (jbe.fused, jbe.differentiable, jbe.conv is None)


@pytest.mark.parametrize("differentiable", [True, False])
def test_make_predict_fn_matches_reference(port_model, bucket_model, mixed_iw, differentiable):
    I, W = mixed_iw[0][::25], mixed_iw[1][::25]
    got = curvefit.make_predict_fn(port_model, differentiable)(torch.from_numpy(I), torch.from_numpy(W))
    want = j_cf.make_predict_fn(bucket_model, differentiable)(jnp.asarray(I), jnp.asarray(W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6)


# ---------------------------------------------------------------------------
# schedule, SyntheticVWW, calibrate_gain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(image_h=12, image_w=17, out_channels=2, kernel=3, stride=1, max_kernel=3),
    dict(image_h=20, image_w=23, out_channels=3, kernel=4, stride=2, max_kernel=5),
    dict(image_h=25, image_w=30, out_channels=2, kernel=5, stride=5),
])
def test_schedule_matches_reference_cycle_for_cycle(kw):
    got, want = list(mapping.schedule(mapping.FPCASpec(**kw))), list(j_map.schedule(j_map.FPCASpec(**kw)))
    assert len(got) == len(want) == mapping.n_cycles(mapping.FPCASpec(**kw))
    for g, w in zip(got, want):
        assert (g.sign, g.channel, g.out_row, g.phase, g.stride, g.max_kernel, g.colp_line) == (
            w.sign, w.channel, w.out_row, w.phase, w.stride, w.max_kernel, w.colp_line)
        np.testing.assert_array_equal(g.window_cols, w.window_cols)


@pytest.mark.parametrize("hw,seed,step,batch", [((24, 24), 0, 0, 5), ((60, 60), 3, 10_001, 4), ((20, 32), 1, 7, 3)])
def test_synthetic_vww_batches_bit_equal(hw, seed, step, batch):
    got = SyntheticVWW(hw, seed=seed).batch_at(step, batch)
    want = JSyntheticVWW(hw, seed=seed).batch_at(step, batch)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", [
    {},
    dict(enc=(8, 1.0), adc=4, circuit=dict(r_metal_mm=2.0), n_samples=512, seed=3),
])
def test_calibrate_gain_matches_reference(kw):
    spec = dict(SPEC_KW)

    def call(mod_sim, mod_adc, circ_cls, map_mod, **extra):
        k = dict(kw)
        args = {}
        if "enc" in k:
            args["enc"] = mod_sim.WeightEncoding(*k.pop("enc"))
        if "adc" in k:
            args["adc"] = mod_adc.ADCConfig(bits=k.pop("adc"))
        if "circuit" in k:
            args["circuit"] = circ_cls(**k.pop("circuit"))
        return mod_sim.calibrate_gain(map_mod.FPCASpec(**spec), **args, **k, **extra)

    gain, r2 = call(fpca_sim, adc, CircuitParams, mapping, device="cpu")
    j_gain, j_r2 = call(j_sim, j_adc, JCircuitParams, j_map)
    assert gain == pytest.approx(j_gain, rel=1e-5)
    assert r2 == pytest.approx(j_r2, rel=1e-5)


# ---------------------------------------------------------------------------
# fpca_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fpca_forward_matches_reference(port_model, bucket_model, mode, batched, masked):
    spec, jspec = mapping.FPCASpec(**SPEC_KW), j_map.FPCASpec(**SPEC_KW)
    imgs = _images(2) if batched else _images(1)[0]
    kernel = _kernel(SPEC_KW)
    bn = np.array([2.0, 0.0, 5.0, 1.0], np.float32)
    mask = _block_mask(spec) if masked else None
    kw = dict(mode=mode, block_mask=mask, adc=adc.ADCConfig(bits=6))
    got = fpca_sim.fpca_forward(torch.from_numpy(imgs), torch.from_numpy(kernel), spec, model=port_model,
                                bn_offset_counts=torch.from_numpy(bn), **kw)
    kw["adc"] = j_adc.ADCConfig(bits=6)
    want = j_sim.fpca_forward(jnp.asarray(imgs), jnp.asarray(kernel), jspec, model=bucket_model,
                              bn_offset_counts=jnp.asarray(bn), **kw)
    assert got.keys() == want.keys()
    counts_close(got["counts"].numpy(), np.asarray(want["counts"]))
    for k in ("v_pos", "v_neg"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    if masked:
        keep = mapping.active_window_mask(spec, mask)
        assert not got["counts"].numpy()[..., ~keep, :].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", ["basis", "cuda"])
def test_fused_shim_warns_and_equals_compiled_run(port_model, backend, masked):
    """The shim (``cuda`` runs its kernel's plain version on CPU tensors)
    warns like the reference and gives ``compile(...).run``'s counts."""
    spec = mapping.FPCASpec(**SPEC_KW)
    imgs, kernel = torch.from_numpy(_images(2, seed=4)), torch.from_numpy(_kernel(SPEC_KW, seed=5))
    bn = torch.tensor([3.0, 1.0, 0.0, 2.0])
    mask = _block_mask(spec) if masked else None
    with pytest.warns(DeprecationWarning, match="deprecation shim"):
        got = fpca_sim.fpca_forward(imgs, kernel, spec, model=port_model, mode="bucket_sigmoid",
                                    bn_offset_counts=bn, block_mask=mask, backend=backend)
    assert got.keys() == {"counts"}
    handle = fpca.compile(fpca.FPCAProgram(spec=spec), backend=backend, device=CPU, weights=kernel,
                          bn_offset=bn, model=port_model)
    assert torch.equal(got["counts"], handle.run(imgs, block_mask=mask))
    with pytest.warns(DeprecationWarning):
        one = fpca_sim.fpca_forward(imgs[0], kernel, spec, model=port_model, mode="bucket_sigmoid",
                                    bn_offset_counts=bn, block_mask=mask, backend=backend)
    assert torch.equal(one["counts"], got["counts"][0])


_REFUSALS = {
    "non-fused third party": dict(backend="_t_dense"),
    "fused oracle": dict(backend="basis", mode="oracle"),
    "fused soft rounding": dict(backend="basis", mode="bucket_sigmoid", hard=False),
    "fused without a model": dict(backend="basis", mode="bucket_sigmoid", model=None),
    "fused without conv": dict(backend="_t_noconv", mode="bucket_sigmoid"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_fpca_forward_refusals_match_reference(port_model, bucket_model, case):
    spec, jspec = mapping.FPCASpec(**SPEC_KW), j_map.FPCASpec(**SPEC_KW)
    imgs, kernel = _images(1), _kernel(SPEC_KW)
    for mod in (backends, j_backends):
        mod.register_backend("_t_dense", fused=False, overwrite=True)(lambda *a, **k: None)
        mod.register_backend("_t_noconv", overwrite=True)(lambda *a, **k: None)
    try:
        kw = dict(_REFUSALS[case])
        jkw = dict(kw)
        kw.setdefault("model", port_model)
        jkw.setdefault("model", bucket_model)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            same_error(
                lambda: j_sim.fpca_forward(jnp.asarray(imgs), jnp.asarray(kernel), jspec, **jkw),
                lambda: fpca_sim.fpca_forward(torch.from_numpy(imgs), torch.from_numpy(kernel), spec, **kw),
            )
    finally:
        for mod in (backends, j_backends):
            for name in ("_t_dense", "_t_noconv"):
                mod._REGISTRY.pop(name, None)


# ---------------------------------------------------------------------------
# FPCAFrontend and the straight-through gradients
# ---------------------------------------------------------------------------


def _layers(port_model, bucket_model, spec_kw=SPEC_KW, **frontend_kw):
    jprog = jfpca.FPCAProgram(spec=j_map.FPCASpec(**spec_kw), **{k: v[0] for k, v in frontend_kw.items()})
    prog = fpca.FPCAProgram(spec=mapping.FPCASpec(**spec_kw), **{k: v[1] for k, v in frontend_kw.items()})
    return core.FPCAFrontend(prog, model=port_model, device="cpu"), jcore.FPCAFrontend(jprog, model=bucket_model)


def _frontend_params(layer, jlayer, seed):
    jp = jlayer.init(jax.random.PRNGKey(seed))
    jp["bn_offset"] = jnp.asarray([3.0, 0.0, 1.0, 6.0], jnp.float32)
    return frontend_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu"), jp


def test_frontend_layer_matches_reference(port_model, bucket_model):
    layer, jlayer = _layers(port_model, bucket_model)
    assert layer.out_shape == jlayer.out_shape
    assert layer.gain == pytest.approx(jlayer.gain, rel=1e-5)
    assert layer.calibration_r2 == pytest.approx(jlayer.calibration_r2, rel=1e-5)
    init = layer.init(torch.Generator().manual_seed(0))
    assert init["kernel"].shape == (4, 5, 5, 3) and init["kernel"].dtype == torch.float32
    assert init["bn_offset"].shape == (4,) and not init["bn_offset"].any()
    p, jp = _frontend_params(layer, jlayer, seed=8)
    imgs = _images(2, seed=9)
    got = layer.apply(p, imgs, train=True).numpy()
    want = np.asarray(jlayer.apply(jp, jnp.asarray(imgs), train=True))
    assert got.shape == want.shape == (2, *layer.out_shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    unit = layer.config.adc.lsb * layer.gain
    dep = layer.apply(p, imgs, train=False).numpy() / unit
    counts_close(np.round(dep), np.round(np.asarray(jlayer.apply(jp, jnp.asarray(imgs), train=False)) / unit))
    for backend in ("basis", "cuda", "no-such-backend"):
        same_error(lambda: jlayer.apply(jp, jnp.asarray(imgs), train=True, backend=backend),
                   lambda: layer.apply(p, imgs, train=True, backend=backend))


def test_frontend_ste_gradients_match_jax_grad(port_model, bucket_model):
    """The reference's own test loss (``mean(apply(p, x, train=True)**2)``,
    tests/test_fpca_system.py) differentiated through the NVM quantiser and
    the SS-ADC STEs; a ReLU'd count of exactly 0 is common here, so the
    clip's gradient at its bounds matters (half, as jnp.clip's)."""
    kw = dict(image_h=24, image_w=24, out_channels=4, kernel=3, stride=2)
    layer, jlayer = _layers(port_model, bucket_model, kw)
    jp = jlayer.init(jax.random.PRNGKey(8))
    jp["bn_offset"] = jnp.asarray([0.0, 4.0, 0.0, 2.0], jnp.float32)
    p = frontend_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    imgs = _images(2, seed=9)
    jgrads = jax.grad(lambda q: jnp.mean(jlayer.apply(q, jnp.asarray(imgs), train=True) ** 2))(jp)
    leaves = [p[k].requires_grad_() for k in ("kernel", "bn_offset")]
    acts = layer.apply(p, imgs, train=True)
    assert bool((acts == 0).any()), "the loss must sit on the ReLU bound somewhere"
    grads = torch.autograd.grad((acts**2).mean(), leaves)
    for k, g in zip(("kernel", "bn_offset"), grads):
        want = np.asarray(jgrads[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("hard", [False, True])
def test_adc_and_encoding_clip_gradients_at_the_bounds_match_jax(hard):
    """Counts landing exactly on 0 and on ``2^b - 1``, and a weight of
    exactly ``w_scale``: ``jnp.clip`` passes half the gradient there (its
    maximum / minimum tie), so the port must too."""
    cfg, jcfg = adc.ADCConfig(bits=4), j_adc.ADCConfig(bits=4)
    lsb = cfg.lsb
    # Q(v) = 0, 15 (both bounds), 7 (inside), 16 and -1 (outside, saturated)
    v = np.array([0.0, 0.02, 15 * lsb, 0.97, 7 * lsb, 0.999, -0.06], np.float32)
    neg = np.array([0.0, 3 * lsb, 0.0, 4 * lsb, 7 * lsb, 0.0, 0.0], np.float32)
    bn = np.float32(2.0)

    def port(f, *xs):
        ts = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
        return torch.autograd.grad(f(*ts).sum(), ts, allow_unused=True, materialize_grads=True)

    def ref(f, *xs):
        return [np.asarray(g) for g in jax.grad(lambda *a: f(*a).sum(), argnums=tuple(range(len(xs))))(
            *map(jnp.asarray, xs))]

    cases = [
        (lambda a: adc.quantize_voltage(a, cfg, hard=hard), lambda a: j_adc.quantize_voltage(a, jcfg, hard=hard), (v,)),
        (lambda a, b: adc.updown_readout(a, b, cfg, bn, hard=hard),
         lambda a, b: j_adc.updown_readout(a, b, jcfg, bn, hard=hard), (v, neg)),
        (lambda a, b: adc.updown_readout(a, b, cfg, 0.0, hard=hard),
         lambda a, b: j_adc.updown_readout(a, b, jcfg, 0.0, hard=hard), (neg, neg)),
    ]
    for f, jf, xs in cases:
        assert np.any(np.asarray(jf(*map(jnp.asarray, xs))) == 0)
        for g, w in zip(port(f, *xs), ref(jf, *xs)):
            np.testing.assert_array_equal(g.numpy(), w)
    spec, jspec = mapping.FPCASpec(6, 6, 2, 2, 2, max_kernel=2), j_map.FPCASpec(6, 6, 2, 2, 2, max_kernel=2)
    kernel = np.array([1.0, -1.0, 0.5, -0.25, 2.0, 0.0, -3.0, 0.75] * 3, np.float32).reshape(2, 2, 2, 3)
    enc, jenc = fpca_sim.WeightEncoding(n_levels=8), j_sim.WeightEncoding(n_levels=8)
    got = port(lambda k: sum(w.sum() * s for w, s in zip(fpca_sim.encode_weights(k, spec, enc, hard=hard), (1, 2))),
               kernel)[0]
    want = ref(lambda k: sum(w.sum() * s for w, s in zip(j_sim.encode_weights(k, jspec, jenc, hard=hard), (1, 2))),
               kernel)[0]
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the training example against its JAX original
# ---------------------------------------------------------------------------


def _load(name: str, file: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return _load("_ref_train_fpca_cnn", "train_fpca_cnn.py"), _load("_torch_train_fpca_cnn", "train_fpca_cnn_torch.py")


SMOKE_KW = dict(image_h=20, image_w=20, out_channels=4, kernel=5, stride=5)
SMOKE_STEPS, SMOKE_BATCH = 3, 4


def _ref_steps(ref, mode, jlayer, data, params):
    """The reference example's ``train`` loop, losses kept (it prints
    only every 25 steps)."""
    from repro.training.optimizer import AdamWConfig, adamw_update, init_adamw

    opt = init_adamw(params)
    cfg = AdamWConfig(lr=2e-3, weight_decay=0.01, warmup_steps=10, total_steps=SMOKE_STEPS)

    def loss_fn(p, images, labels):
        if mode == "hw_aware":
            acts = jlayer.apply(p["frontend"], images, train=True)
        else:
            acts = ref.ideal_frontend(p["frontend"]["kernel"], images)
        logits = ref.head_apply(p["head"], acts)
        onehot = jax.nn.one_hot(labels, 2)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for step in range(SMOKE_STEPS):
        b = data.batch_at(step, SMOKE_BATCH)
        loss, grads = grad_fn(params, jnp.asarray(b["images"]), jnp.asarray(b["labels"]))
        params, opt, _ = adamw_update(grads, opt, params, cfg)
        losses.append(float(loss))
    return params, losses


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("mode", ["hw_aware", "naive"])
def test_training_example_matches_reference(examples, port_model, bucket_model, tmp_path, mode):
    """3 AdamW steps of each mode from the reference's initial parameters:
    the same loss per step, the same parameters (and the reference's own
    ``train`` lands on the replayed loop's), the same oracle logits, and
    export bundles with the same keys and meta."""
    ref, tw = examples
    layer, jlayer = _layers(port_model, bucket_model, SMOKE_KW, adc=(j_adc.ADCConfig(bits=4), adc.ADCConfig(bits=4)),
                            enc=(j_sim.WeightEncoding(n_levels=8), fpca_sim.WeightEncoding(n_levels=8)))
    data = SyntheticVWW((20, 20))
    jp0 = {"frontend": jlayer.init(jax.random.PRNGKey(0)),
           "head": ref.init_head(jax.random.PRNGKey(1), *jlayer.out_shape)}
    jp, jlosses = _ref_steps(ref, mode, jlayer, JSyntheticVWW((20, 20)), jp0)
    jtrained = ref.train(mode, jlayer, JSyntheticVWW((20, 20)), SMOKE_STEPS, SMOKE_BATCH)
    for k in ("frontend", "head"):
        for name in jp[k]:
            np.testing.assert_array_equal(np.asarray(jtrained[k][name]), np.asarray(jp[k][name]))

    p, history = tw.train(mode, layer, data, SMOKE_STEPS, SMOKE_BATCH, params=_np_tree(jp0))
    np.testing.assert_allclose([h["loss"] for h in history], jlosses, rtol=0, atol=1e-5)
    assert all(np.isfinite(h["grad_norm"]) for h in history)
    for k in ("frontend", "head"):
        for name, want in _np_tree(jp[k]).items():
            np.testing.assert_allclose(p[k][name].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{k}/{name}")

    # the reference's trained network, carried across, on the oracle
    tp = {"frontend": frontend_params_from_numpy(_np_tree(jp["frontend"]), device="cpu"),
          "head": head_params_from_numpy([_np_tree(jp["head"])], device="cpu")[0]}
    imgs = data.batch_at(10_000, 8)["images"]
    got = tw.head_apply(tp["head"], layer.apply(tp["frontend"], imgs, train=False)).numpy()
    want = np.asarray(ref.head_apply(jp["head"], jlayer.apply(jp["frontend"], jnp.asarray(imgs), train=False)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))

    paths = tmp_path / "port.npz", tmp_path / "ref.npz"
    tw.save_export(str(paths[0]), layer, tp, calib_images=imgs)
    ref.save_export(str(paths[1]), jlayer, jp, calib_images=imgs)
    got, want = np.load(paths[0]), np.load(paths[1])
    assert sorted(got.files) == sorted(want.files)
    meta, jmeta = (json.loads(bytes(b["meta"]).decode()) for b in (got, want))
    assert meta.keys() == jmeta.keys()
    assert meta.pop("input_scale") == pytest.approx(jmeta.pop("input_scale"), rel=1e-5)
    assert meta == jmeta
    for k in got.files:
        if k != "meta":
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
