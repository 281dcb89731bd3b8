"""The port's core modules against the reference on the same numpy inputs:
spec geometry, window extraction, weight encoding, the SS-ADC, the circuit
oracle and the bucket curvefit model.

Tolerances: geometry, masks, ``extract_windows``, ``encode_weights`` and the
ADC readout are exact (gathers, comparisons and IEEE-exact elementwise ops
in the same order).  The circuit oracle and the curvefit predictions differ
by float32 rounding only (tanh, sums taken in another order), bounded by a
few 1e-6 V — far below the ADC's 3.9e-3 V step.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import curvefit as j_cf
from repro.core import device_models as j_dm
from repro.core import fpca_sim as j_sim
from repro.core import mapping as j_map
from repro_torch.convert import bucket_model_from_dict
from repro_torch.core import adc, curvefit, device_models, fpca_sim, mapping

SPECS = [
    dict(image_h=24, image_w=24, out_channels=4, kernel=5, stride=5),            # reshape path
    dict(image_h=24, image_w=20, out_channels=3, kernel=3, stride=2),            # unfold path
    dict(image_h=26, image_w=22, out_channels=2, kernel=4, stride=3, padding=1),  # padded unfold
    dict(image_h=40, image_w=40, out_channels=2, kernel=5, stride=5, binning=2),  # binned
]


def _specs(kw: dict) -> tuple[mapping.FPCASpec, j_map.FPCASpec]:
    return mapping.FPCASpec(**kw), j_map.FPCASpec(**kw)


@pytest.mark.parametrize("kw", SPECS)
def test_geometry_and_window_mask_exact(kw):
    spec, jspec = _specs(kw)
    assert mapping.output_dims(spec) == j_map.output_dims(jspec)
    assert spec.n_active_pixels == jspec.n_active_pixels
    rng = np.random.default_rng(0)
    b = spec.skip_block
    block = rng.random((math.ceil(spec.eff_h / b), math.ceil(spec.eff_w / b))) < 0.3
    np.testing.assert_array_equal(
        mapping.active_window_mask(spec, block), j_map.active_window_mask(jspec, block)
    )
    np.testing.assert_array_equal(mapping.active_window_mask(spec, None), True)


@pytest.mark.parametrize("kw", SPECS)
def test_extract_windows_exact(kw):
    """Channel-major (c_i, n, n) flattening on both the reshape and the
    unfold path is an exact gather.  Binning averages b*b pixels, and the
    two frameworks sum them in another order: one float32 ulp of a value
    below 1 (1.2e-7)."""
    spec, jspec = _specs(kw)
    images = np.random.default_rng(1).uniform(0, 1, (2, spec.image_h, spec.image_w, 3))
    images = images.astype(np.float32)
    got = fpca_sim.extract_windows(torch.from_numpy(images), spec).numpy()
    want = np.asarray(j_sim.extract_windows(jnp.asarray(images), jspec))
    if spec.binning == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    one = fpca_sim.extract_windows(torch.from_numpy(images[0]), spec).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("kw", SPECS[:3])
def test_encode_weights_exact(kw):
    spec, jspec = _specs(kw)
    k = spec.kernel
    kernel = (np.random.default_rng(2).normal(size=(spec.out_channels, k, k, 3)) * 0.6).astype(
        np.float32
    )
    enc, jenc = fpca_sim.WeightEncoding(), j_sim.WeightEncoding()
    got = fpca_sim.encode_weights(torch.from_numpy(kernel), spec, enc)
    want = j_sim.encode_weights(jnp.asarray(kernel), jspec, jenc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="inconsistent"):
        fpca_sim.encode_weights(torch.zeros(2, k + 1, k + 1, 3), spec, enc)


@pytest.mark.parametrize("bits", [4, 8])
def test_updown_readout_exact(bits):
    """Half-to-even rounding and the clamps agree count for count, including
    voltages placed exactly on half-LSB boundaries."""
    rng = np.random.default_rng(3)
    cfg, jcfg = adc.ADCConfig(bits=bits), j_adc.ADCConfig(bits=bits)
    v_pos = rng.uniform(-0.1, 1.1, 4096).astype(np.float32)
    v_neg = rng.uniform(-0.1, 1.1, 4096).astype(np.float32)
    v_pos[:64] = (np.arange(64) + 0.5) * np.float32(cfg.lsb)
    bn = rng.integers(0, 40, 4096).astype(np.float32)
    got = adc.updown_readout(torch.from_numpy(v_pos), torch.from_numpy(v_neg), cfg,
                             torch.from_numpy(bn)).numpy()
    want = np.asarray(j_adc.updown_readout(jnp.asarray(v_pos), jnp.asarray(v_neg), jcfg,
                                           jnp.asarray(bn)))
    np.testing.assert_array_equal(got, want)


def test_analog_dot_product_matches():
    rng = np.random.default_rng(4)
    I = rng.uniform(0, 1, (512, 75)).astype(np.float32)
    W = rng.uniform(0, 1, (512, 75)).astype(np.float32)
    for params in (device_models.CircuitParams(), device_models.CircuitParams(r_metal_mm=3.0)):
        jparams = j_dm.CircuitParams(r_metal_mm=params.r_metal_mm)
        got = device_models.analog_dot_product(torch.from_numpy(I), torch.from_numpy(W), params)
        want = j_dm.analog_dot_product(jnp.asarray(I), jnp.asarray(W), jparams)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_bucket_model_round_trips_and_predicts_like_reference(bucket_model, mixed_iw):
    """The reference's fit, handed over through to_dict(), predicts the same
    voltages in the port (float32 rounding only)."""
    model = bucket_model_from_dict(bucket_model.to_dict())
    for k, v in bucket_model.to_dict().items():
        np.testing.assert_array_equal(np.asarray(model.to_dict()[k]), np.asarray(v))
    I, W = mixed_iw[0][::10], mixed_iw[1][::10]
    got = curvefit.predict_sigmoid(model, torch.from_numpy(I), torch.from_numpy(W)).numpy()
    want = np.asarray(j_cf.predict_sigmoid(bucket_model, jnp.asarray(I), jnp.asarray(W)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    got_h = curvefit.predict_hard(model, torch.from_numpy(I), torch.from_numpy(W)).numpy()
    want_h = np.asarray(j_cf.predict_hard(bucket_model, jnp.asarray(I), jnp.asarray(W)))
    # a window whose estimate sits within rounding of a bucket edge may
    # select the neighbouring bucket on one side; all others agree
    assert (np.abs(got_h - want_h) <= 5e-6).mean() > 0.995


def test_fit_bucket_model_matches_reference(bucket_model, mixed_iw):
    """The port fits its own model on the host.  The oracle's float32 tanh
    differs from XLA's by an ulp, which moves the bisected bucket centres
    and the least-squares coefficients slightly; the fitted model's
    predictions must agree to 1e-4 V (a fortieth of an ADC step)."""
    model = curvefit.fit_bucket_model(n_pixels=75, device="cpu")
    ref = bucket_model.to_dict()
    np.testing.assert_array_equal(model.bucket_exps, ref["bucket_exps"])
    np.testing.assert_array_equal(model.f_avg.exps, ref["f_avg_exps"])
    np.testing.assert_allclose(model.centers, ref["centers"], atol=1e-5)
    np.testing.assert_allclose(model.v_centers, ref["v_centers"], atol=1e-5)
    I, W = mixed_iw[0][::10], mixed_iw[1][::10]
    got = curvefit.predict_sigmoid(model, torch.from_numpy(I), torch.from_numpy(W)).numpy()
    want = np.asarray(j_cf.predict_sigmoid(bucket_model, jnp.asarray(I), jnp.asarray(W)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_analog_read_bucket_modes(bucket_model):
    model = bucket_model_from_dict(bucket_model.to_dict())
    rng = np.random.default_rng(5)
    I = rng.uniform(0, 1, (3, 4, 75)).astype(np.float32)
    W = rng.uniform(0, 1, (6, 75)).astype(np.float32)
    got = fpca_sim._analog_read(torch.from_numpy(I), torch.from_numpy(W), "bucket_sigmoid", None, model, 75)
    want = j_sim._analog_read(jnp.asarray(I), jnp.asarray(W), "bucket_sigmoid", None,
                              bucket_model, 75)
    assert got.shape == (3, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        fpca_sim._analog_read(torch.from_numpy(I), torch.from_numpy(W), "bucket_linear", None, model, 75)
