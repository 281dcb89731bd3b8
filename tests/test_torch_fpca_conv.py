"""The port's fpca_conv kernel module and ops layer against the reference.

On this host the CUDA kernel cannot run: ``fpca_conv_cuda`` takes its plain
PyTorch version for CPU tensors, and the kernel itself is held against that
version on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``).

Count tolerance (the reference's own kernel-vs-oracle bound,
``tests/test_kernels_fpca_conv.py``): at most 1 ADC count and fewer than 5%
of counts off — sums taken in another order can move a voltage across a
round-half boundary.  Bucket sizing, hysteresis and the model encoding are
exact.  Inside the port, compacted region-skip counts equal masked dense
counts bit for bit (row-independent math).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_checks import counts_close
from repro.core.adc import ADCConfig as JADCConfig
from repro.core.fpca_sim import WeightEncoding as JWeightEncoding
from repro.core.mapping import FPCASpec as JFPCASpec
from repro.kernels.fpca_conv import kernel as j_kernel
from repro.kernels.fpca_conv import ops as j_ops
from repro.kernels.fpca_conv.ref import fpca_conv_ref as j_fpca_conv_ref
from repro_torch.convert import bucket_model_from_dict
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import _exponent_pairs
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.mapping import FPCASpec
from repro_torch.kernels.fpca_conv import kernel, ops
from repro_torch.kernels.fpca_conv.ref import fpca_conv_ref


@pytest.fixture(scope="module")
def models(bucket_model):
    return bucket_model, bucket_model_from_dict(bucket_model.to_dict())


def _data(m: int, c: int, seed: int = 0, n: int = 75):
    rng = np.random.default_rng(seed)
    patches = rng.uniform(0, 1, (m, n)).astype(np.float32)
    w = rng.uniform(0, 1, (n, c)).astype(np.float32)
    bn = rng.integers(0, 30, (c,)).astype(np.float32)
    return patches, w, np.roll(w, 1, axis=1), bn


def _port_counts(model, bits, patches, w_pos, w_neg, bn, row_valid=None, fn=None):
    tables = kernel.conv_tables(model, ADCConfig(bits=bits), patches.shape[1], torch.device("cpu"))
    planes = kernel.weight_planes(torch.from_numpy(w_pos), torch.from_numpy(w_neg), tables)
    fn = fn or kernel.fpca_conv_basis
    rv = None if row_valid is None else torch.from_numpy(row_valid)
    return fn(torch.from_numpy(patches), planes, tables, torch.from_numpy(bn), row_valid=rv)


def test_bucket_tables_and_weight_planes_match(models):
    jm, pm = models
    tj, tp = j_kernel._bucket_tables(jm), kernel._bucket_tables(pm)
    assert list(tj["by_pair"]) == list(tp["by_pair"]) == [tuple(e) for e in _exponent_pairs(3)]
    for pair in tj["by_pair"]:
        np.testing.assert_array_equal(tp["by_pair"][pair], tj["by_pair"][pair])
    np.testing.assert_array_equal(tp["const"], tj["const"])
    _, w, _, _ = _data(1, 8)
    mask = np.ones(75, np.float32)
    want = j_kernel.precompute_weight_planes(jnp.asarray(w), jnp.asarray(mask), jm)
    got = kernel.precompute_weight_planes(torch.from_numpy(w), torch.from_numpy(mask), pm)
    for k in ("w_pows", "cs", "aw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("m,c", [(64, 8), (1, 1)])
def test_plain_version_matches_reference_ref_and_basis(models, m, c):
    """The plain version (and the port's oracle) against the reference's
    oracle and its XLA basis form, 8-bit ADC."""
    jm, pm = models
    patches, w_pos, w_neg, bn = _data(m, c, seed=m + c)
    got = _port_counts(pm, 8, patches, w_pos, w_neg, bn)
    args = (jnp.asarray(patches), jnp.asarray(w_pos), jnp.asarray(w_neg), jm, JADCConfig(),
            jnp.asarray(bn))
    counts_close(got, j_fpca_conv_ref(*args))
    counts_close(got, j_ops.fpca_conv_basis_jnp(*args))
    counts_close(fpca_conv_ref(torch.from_numpy(patches), torch.from_numpy(w_pos),
                                torch.from_numpy(w_neg), pm, ADCConfig(),
                                torch.from_numpy(bn)), j_fpca_conv_ref(*args))


def test_plain_version_matches_reference_basis_16bit(models):
    """16-bit ADC: lsb = 15 uV, so a <= 1-count agreement with the
    reference's basis form (the same algebra) pins the analog voltages to
    ~1e-5 V.  Against the dense oracle (another algebra) each phase can flip
    on its own at this resolution — the reference's basis and oracle differ
    on 3.5% of counts here too — so that comparison stays at 8 bits."""
    jm, pm = models
    patches, w_pos, w_neg, bn = _data(128, 32, seed=160)
    got = _port_counts(pm, 16, patches, w_pos, w_neg, bn)
    want = j_ops.fpca_conv_basis_jnp(jnp.asarray(patches), jnp.asarray(w_pos),
                                     jnp.asarray(w_neg), jm, JADCConfig(bits=16), jnp.asarray(bn))
    counts_close(got, want)


def test_plain_version_matches_pallas_kernel_interpret(models):
    """The TPU kernel itself, run as its own tests run it (interpret mode,
    lane-padded to 128)."""
    jm, pm = models
    patches, w_pos, w_neg, bn = _data(64, 8, seed=3)
    pad = ((0, 0), (0, 128 - 75))
    mask = np.r_[np.ones(75), np.zeros(53)].astype(np.float32)
    want = j_kernel.fpca_conv_pallas(
        jnp.asarray(np.pad(patches, pad)), jnp.asarray(np.pad(w_pos, pad[::-1])),
        jnp.asarray(np.pad(w_neg, pad[::-1])), jm, JADCConfig(), jnp.asarray(bn),
        mask=jnp.asarray(mask), n_real=75, block_m=64, block_c=128, interpret=True,
    )
    counts_close(_port_counts(pm, 8, patches, w_pos, w_neg, bn), want)


def test_row_valid_zeroes_padding_rows_exactly(models):
    _, pm = models
    patches, w_pos, w_neg, bn = _data(96, 8, seed=4)
    valid = (np.arange(96) % 3 != 0).astype(np.float32)
    dense = _port_counts(pm, 8, patches, w_pos, w_neg, bn)
    masked = _port_counts(pm, 8, patches, w_pos, w_neg, bn, row_valid=valid)
    assert torch.equal(masked[valid == 0], torch.zeros_like(masked[valid == 0]))
    assert torch.equal(masked[valid == 1], dense[valid == 1])


def test_cuda_wrapper_takes_plain_version_on_cpu(models):
    """A CPU tensor goes to the plain version and is not counted as a launch."""
    _, pm = models
    patches, w_pos, w_neg, bn = _data(50, 8, seed=5)
    before = kernel.fpca_conv_cuda.launches
    got = _port_counts(pm, 8, patches, w_pos, w_neg, bn, fn=kernel.fpca_conv_cuda)
    assert torch.equal(got, _port_counts(pm, 8, patches, w_pos, w_neg, bn))
    assert kernel.fpca_conv_cuda.launches == before


def test_conv_tables_reject_what_the_kernel_cannot_combine(models):
    _, pm = models
    deg2 = dataclasses.replace(pm, bucket_exps=_exponent_pairs(2), bucket_coeffs=pm.bucket_coeffs[:, :6])
    with pytest.raises(ValueError, match="degree-3"):
        kernel.conv_tables(deg2, ADCConfig(), 75, torch.device("cpu"))
    many = dataclasses.replace(pm, bucket_coeffs=np.tile(pm.bucket_coeffs, (2, 1)),
                               v_centers=np.tile(pm.v_centers, 2))
    with pytest.raises(ValueError, match="buckets"):
        kernel.conv_tables(many, ADCConfig(), 75, torch.device("cpu"))


def test_window_bucket_and_sticky_bucket_exact():
    for m_total in (1, 7, 64, 200):
        for n_keep in range(0, m_total + 3):
            assert ops.window_bucket(n_keep, m_total) == j_ops.window_bucket(n_keep, m_total)
    rng = np.random.default_rng(6)
    ticks = rng.integers(0, 300, 200)
    for patience in (1, 3):
        a, b = ops.StickyBucket(patience), j_ops.StickyBucket(patience)
        for n in ticks:
            if n < 20:
                a.observe_idle()
                b.observe_idle()
                continue
            assert a.bucket(int(n), 256) == b.bucket(int(n), 256)
        assert (a.switches, a.shrinks_deferred) == (b.switches, b.shrinks_deferred)
    with pytest.raises(ValueError):
        ops.StickyBucket(0)


def test_freeze_thaw_and_pad_to_lanes_match(models):
    jm, pm = models
    assert ops.freeze_model(pm) == j_ops.freeze_model(jm)
    assert ops.freeze_model(ops.thaw_model(ops.freeze_model(pm))) == ops.freeze_model(pm)
    x = np.random.default_rng(7).uniform(0, 1, (5, 75)).astype(np.float32)
    for axis in (0, 1):
        got, mask = ops.pad_to_lanes(torch.from_numpy(x), axis=axis)
        want, jmask = j_ops.pad_to_lanes(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_fpca_conv_parity_grid_dense_masked_zero_kept(models):
    """fpca_conv over the n_keep grid {0, 1, pow2 +/- 1, M}: dense counts
    match the reference within the count bound, masked counts equal the
    port's dense counts times the mask bit for bit (so they match the
    reference's masked counts, which its own tests pin to dense x mask),
    and an all-skipped mask returns exact zeros without a launch."""
    jm, pm = models
    kw = dict(image_h=24, image_w=24, out_channels=6, kernel=3, stride=2)
    spec, jspec = FPCASpec(**kw), JFPCASpec(**kw)
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    kern = (rng.normal(size=(6, 3, 3, 3)) * 0.3).astype(np.float32)
    bn = rng.integers(0, 20, 6).astype(np.float32)
    want = np.asarray(j_ops.fpca_conv(
        jnp.asarray(images), jnp.asarray(kern), jm, spec=jspec, adc=JADCConfig(),
        enc=JWeightEncoding(), bn_offset=jnp.asarray(bn), impl="basis",
    ))
    args = (torch.from_numpy(images), torch.from_numpy(kern), pm)
    common = dict(spec=spec, bn_offset=torch.from_numpy(bn), enc=WeightEncoding())
    dense = {impl: ops.fpca_conv(*args, impl=impl, **common) for impl in ("basis", "cuda")}
    assert torch.equal(dense["basis"], dense["cuda"])
    counts_close(dense["basis"], want)
    M = want.shape[0] * want.shape[1] * want.shape[2]
    for n_keep in (0, 1, 7, 8, 9, 63, 64, 65, M):
        flat = np.zeros(M, bool)
        flat[rng.choice(M, n_keep, replace=False)] = True
        mask = flat.reshape(want.shape[:3])
        got = ops.fpca_conv(*args, impl="basis", window_mask=mask, **common)
        keep = torch.from_numpy(mask)[..., None].float()
        assert torch.equal(got, dense["basis"] * keep), n_keep
        counts_close(got, want * mask[..., None])
    with pytest.raises(ValueError, match="m_bucket"):
        ops.fpca_conv(*args, impl="basis", window_mask=np.ones((2, 11, 11), bool), m_bucket=4,
                      **common)
