"""The port's int8 serving path against the reference: exact int32
accumulation, quantisation, calibration, binding, the int8 head and the
int8 bucket-transfer LUT, on 20x20 frames (a 4x4 window grid) with the
reference's parameters handed over as numpy.

Tolerances, each with its reason:

* int32 accumulators, ``w_q``, the transfer LUT, signatures and error
  messages — equal: integer arithmetic is exact in any order, the LUT is
  built in float64 from the same constants, and the rest are contracts;
* scales — within 1e-6 relative: weight scales are one IEEE division of
  the same numbers, activation scales come from an f32 forward pass whose
  sums run in another order;
* dequantised conv outputs — within 1e-6 relative (one multiply-add on
  equal accumulators, which XLA may contract into an FMA);
* int8 logits on shared quantised parameters — within 1e-5 of the largest
  logit: the stages' int32 accumulators are equal, and a later stage's
  requantised input can only move where an f32 ulp crosses a rounding
  point;
* counts through the int8 transfer — at most 1 ADC count and fewer than 5%
  off (round-half flips of the f32 sums before the table gather).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fpca as jfpca
from _port_checks import same_error
from repro.core.mapping import FPCASpec as JFPCASpec
from repro.kernels.fpca_conv import kernel as j_kernel
from repro.kernels.fpca_conv import ops as j_ops
from repro.models import quant as jquant
from repro_torch import fpca
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy
from repro_torch.core.adc import ADCConfig
from repro_torch.kernels.fpca_conv import ops
from repro_torch.kernels.fpca_conv.kernel import conv_tables
from repro_torch.models import quant
from repro_torch.models.layers import _same_pads

H = 20
CHAIN = [("DenseSpec", (16,), {"activation": "relu"}), ("DenseSpec", (3,), {})]
CONV_CHAIN = [("ConvSpec", (6, 3, 1, "SAME"), {"activation": "relu"}), ("PoolSpec", (2, 2, "avg"), {}),
              ("DenseSpec", (5,), {})]


def _program(mod, head=CHAIN, arch: str | None = None, precision: str = "int8"):
    spec = (JFPCASpec if mod is jfpca else fpca.FPCASpec)(image_h=H, image_w=H, out_channels=4, kernel=5, stride=5)
    if arch is not None:
        return mod.build_model({"arch": arch, "spec": spec, "n_classes": 3, "width": 4}).replace(precision=precision)
    layers = tuple(getattr(mod, cls)(*args, **kw) for cls, args, kw in head)
    return mod.FPCAModelProgram(frontend=mod.FPCAProgram(spec=spec), head=layers, precision=precision)


HEADS = {"chain": dict(head=CHAIN), "conv_chain": dict(head=CONV_CHAIN),
         "fpca_resnet": dict(arch="fpca_resnet"), "fpca_detect": dict(arch="fpca_detect")}


def _numpy(params):
    if isinstance(params, dict):
        return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _counts(seed: int = 0, n: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, 4, 4, 4)).astype(np.float32)


def _kernel(seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(4, 5, 5, 3)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


# ---------------------------------------------------------------------------
# exact int32 accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(2, 64, 5), (1, 1024, 8), (3, 1500, 7), (2, 4096, 16)])
def test_bank_dot_is_exact_int32(m, k, n):
    rng = np.random.default_rng(k)
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    out = quant.quant_bank_dot(torch.from_numpy(x_q), torch.from_numpy(w_q))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), x_q.astype(np.int64) @ w_q.astype(np.int64))
    lead = quant.quant_bank_dot(torch.from_numpy(x_q).reshape(m, 1, k).expand(m, 2, k), torch.from_numpy(w_q))
    np.testing.assert_array_equal(lead.numpy(), np.repeat(out.numpy()[:, None], 2, axis=1))


def _numpy_conv(x_q: np.ndarray, w_q: np.ndarray, stride: int, padding: str) -> np.ndarray:
    """Integer NHWC convolution, one kernel tap at a time in int64."""
    _, h, w, _ = x_q.shape
    c_out, k, _, _ = w_q.shape
    if padding == "SAME":
        (ht, hb), (wl, wr) = _same_pads(h, k, stride), _same_pads(w, k, stride)
        x_q = np.pad(x_q, ((0, 0), (ht, hb), (wl, wr), (0, 0)))
    h_o, w_o = (x_q.shape[1] - k) // stride + 1, (x_q.shape[2] - k) // stride + 1
    out = np.zeros((x_q.shape[0], h_o, w_o, c_out), np.int64)
    for di in range(k):
        for dj in range(k):
            patch = x_q[:, di:di + stride * h_o:stride, dj:dj + stride * w_o:stride].astype(np.int64)
            out += patch @ w_q[:, di, dj, :].astype(np.int64).T
    return out


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c_in,k", [(5, 3), (130, 3)])
def test_conv2d_int8_is_exact(padding, stride, c_in, k):
    """im2col + the chunked bank dot against a numpy integer conv (c_in x k
    x k = 1170 > 1024 takes the chunked path), and the dequantised output
    against the reference's ``conv2d_int8``."""
    rng = np.random.default_rng(c_in * 10 + stride)
    x = rng.normal(size=(2, 9, 7, c_in)).astype(np.float32)
    qp = {"w_q": rng.integers(-127, 128, size=(6, k, k, c_in)).astype(np.int8),
          "w_scale": rng.uniform(0.01, 0.1, 6).astype(np.float32),
          "b": rng.normal(size=6).astype(np.float32),
          "x_scale": np.float32(np.abs(x).max() / 127.0)}
    tqp = {key: torch.as_tensor(v) for key, v in qp.items()}
    acc = quant.conv2d_int8_acc(tqp, torch.from_numpy(x), stride, padding)
    x_q = np.clip(np.round(x / qp["x_scale"]), -127, 127)
    want = _numpy_conv(x_q, qp["w_q"], stride, padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    ref = np.asarray(jquant.conv2d_int8({key: jnp.asarray(v) for key, v in qp.items()}, jnp.asarray(x),
                                        stride, padding))
    got = quant.conv2d_int8(tqp, torch.from_numpy(x), stride, padding).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_leaf_helpers_match_reference():
    g = np.random.default_rng(0).normal(size=(9, 4)).astype(np.float32)
    q_j, s_j = jquant.quantize_leaf_symmetric(jnp.asarray(g))
    q, s = quant.quantize_leaf_symmetric(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    assert float(s) == float(s_j)
    assert float((quant.dequantize_leaf(q, s) - torch.from_numpy(g)).abs().max()) <= float(s) * 0.5 + 1e-7
    q_c, s_c = quant.quantize_symmetric(torch.from_numpy(g), channel_axis=1)
    q_cj, s_cj = jquant.quantize_symmetric(jnp.asarray(g), channel_axis=1)
    np.testing.assert_array_equal(q_c.numpy(), np.asarray(q_cj))
    np.testing.assert_array_equal(s_c.numpy(), np.asarray(s_cj))


# ---------------------------------------------------------------------------
# quantisation, calibration, binding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", list(HEADS))
def test_quantize_head_params_matches_reference(which):
    jp, pp = _program(jfpca, **HEADS[which]), _program(fpca, **HEADS[which])
    hp = _numpy(jp.replace(precision="f32").init_head(jax.random.PRNGKey(1)))
    counts = _counts(1)
    qj = jquant.quantize_head_params(jp, hp, sample_counts=counts)
    qp = quant.quantize_head_params(pp, head_params_from_numpy(hp, device="cpu"),
                                    sample_counts=torch.from_numpy(counts))
    pairs = [(qj[n], qp[n]) for n in qj] if isinstance(qj, dict) else list(zip(qj, qp))
    assert len(pairs) == len(qp)
    for a, b in pairs:
        assert set(a) == set(b)
        if not a:
            continue
        np.testing.assert_array_equal(b["w_q"].numpy(), np.asarray(a["w_q"]))
        assert b["w_q"].dtype == torch.int8 and b["x_scale"].shape == ()
        np.testing.assert_allclose(b["w_scale"].numpy(), np.asarray(a["w_scale"]), rtol=1e-6)
        np.testing.assert_allclose(float(b["x_scale"]), float(a["x_scale"]), rtol=1e-6)
        np.testing.assert_array_equal(b["b"].numpy(), np.asarray(a["b"]))
    # data-free calibration (full-scale counts), through bind_head_params
    free_j = jp.bind_head_params(hp)
    free = pp.bind_head_params(head_params_from_numpy(hp, device="cpu"), device="cpu")
    assert quant.is_quantized_params(free) and not quant.is_quantized_params(hp)
    for a, b in ([(free_j[n], free[n]) for n in free_j] if isinstance(free_j, dict) else zip(free_j, free)):
        if a:
            np.testing.assert_allclose(float(b["x_scale"]), float(a["x_scale"]), rtol=1e-6)


@pytest.mark.parametrize("which", ["conv_chain", "fpca_resnet"])
def test_act_scale_pack_roundtrip(which):
    jp, pp = _program(jfpca, **HEADS[which]), _program(fpca, **HEADS[which])
    hp = _numpy(jp.replace(precision="f32").init_head(jax.random.PRNGKey(1)))
    counts = _counts(0, n=2)
    want = jquant.calibrate_head_scales(jp, jp._bind_f32(hp), counts)
    scales = quant.calibrate_head_scales(pp, pp._bind_f32(head_params_from_numpy(hp, device="cpu")),
                                         torch.from_numpy(counts))
    packed = quant.pack_act_scales(pp, scales)
    np.testing.assert_allclose(packed, jquant.pack_act_scales(jp, want), rtol=1e-6)
    back = quant.unpack_act_scales(pp, packed)
    if isinstance(scales, dict):
        assert back == pytest.approx(scales, rel=1e-6)
    else:
        assert packed.shape == (len(pp.head),) and back[1] is None
        assert [b is None for b in back] == [s is None for s in scales]
        assert [b for b in back if b] == pytest.approx([s for s in scales if s], rel=1e-6)
    same_error(lambda: jquant.unpack_act_scales(jp, packed[:-1]), lambda: quant.unpack_act_scales(pp, packed[:-1]))


BIND_CASES = ["missing_key", "bad_w_q", "stages", "params_on_pool", "graph_not_dict", "graph_keys"]


@pytest.mark.parametrize("case", BIND_CASES)
def test_bind_quant_errors_match_reference(case):
    which = "conv_chain" if case == "params_on_pool" else "fpca_resnet" if case.startswith("graph") else "chain"
    jp, pp = _program(jfpca, **HEADS[which]), _program(fpca, **HEADS[which])
    hp = _numpy(jp.replace(precision="f32").init_head(jax.random.PRNGKey(0)))
    q = _numpy(jquant.quantize_head_params(jp, hp))

    def bad():
        if case == "graph_not_dict":
            return list(q.values())
        if case == "graph_keys":
            return {k: v for k, v in q.items() if k != "fc"}
        p = [dict(s) for s in q]
        if case == "missing_key":
            del p[0]["x_scale"]
        elif case == "bad_w_q":
            p[1]["w_q"] = p[1]["w_q"][:-1]
        elif case == "stages":
            p = p[:1]
        else:
            p[1] = dict(p[0])
        return p

    same_error(lambda: jquant.bind_quant_head_params(jp, bad()), lambda: quant.bind_quant_head_params(pp, bad()))
    bound = pp.bind_head_params(head_params_from_numpy(q, device="cpu"))
    assert quant.is_quantized_params(bound)


@pytest.mark.parametrize("which", list(HEADS))
def test_signature_precision_entry_byte_equal(which):
    jp, pp = _program(jfpca, **HEADS[which]), _program(fpca, **HEADS[which])
    assert repr(pp.signature()) == repr(jp.signature())
    assert pp.signature()[-1] == ("precision", "int8")
    f32 = pp.replace(precision="f32")
    assert not any("precision" in str(e) for e in f32.signature())
    assert repr(f32.signature()) == repr(jp.replace(precision="f32").signature())
    same_error(lambda: jp.replace(precision="fp4"), lambda: pp.replace(precision="fp4"))


# ---------------------------------------------------------------------------
# the int8 head against the reference on shared quantised parameters
# ---------------------------------------------------------------------------


def _first_stage_acc_ref(jp, q, x: np.ndarray) -> np.ndarray:
    """The reference's int32 accumulators of the first parameterized stage:
    its own requantise, then its own conv / bank dot on the carrier with
    unit scales and zero bias (so the dequantised result is the integer)."""
    if jp.is_graph_head:
        node = jp.head._param_nodes()[0]
        s, op = q[node.name], node.op
    else:
        i = next(i for i, p in enumerate(q) if p)
        s, op = q[i], jp.head[i]
    x_q = np.asarray(jquant._requant(jnp.asarray(x), s["x_scale"]))
    c = s["w_q"].shape[0] if s["w_q"].ndim == 4 else s["w_q"].shape[1]
    unit = {"w_q": jnp.asarray(s["w_q"]), "w_scale": jnp.ones(c), "b": jnp.zeros(c), "x_scale": jnp.float32(1.0)}
    if s["w_q"].ndim == 4:
        return np.asarray(jquant.conv2d_int8(unit, jnp.asarray(x_q), op.stride, op.padding)).astype(np.int64)
    return np.asarray(jquant.quant_bank_dot(jnp.asarray(x_q.reshape(len(x_q), -1)), unit["w_q"]))


@pytest.mark.parametrize("which", list(HEADS))
def test_int8_head_matches_reference_on_shared_quantised_params(which):
    jp, pp = _program(jfpca, **HEADS[which]), _program(fpca, **HEADS[which])
    hp = _numpy(jp.replace(precision="f32").init_head(jax.random.PRNGKey(2)))
    counts = _counts(3)
    q = _numpy(jquant.quantize_head_params(jp, hp, sample_counts=counts))
    tq = pp.bind_head_params(head_params_from_numpy(q, device="cpu"))
    x = counts * np.float32(jp.input_scale)
    if pp.is_graph_head:                 # every first stage reads the input
        node = pp.head._param_nodes()[0]
        op, first = node.op, tq[node.name]
    else:
        i = next(i for i, p in enumerate(tq) if p)
        op, first = pp.head[i], tq[i]
    if first["w_q"].ndim == 4:
        acc = quant.conv2d_int8_acc(first, torch.from_numpy(x), op.stride, op.padding)
    else:
        acc = quant.linear_int8_acc(first, torch.from_numpy(x.reshape(len(x), -1)))
    np.testing.assert_array_equal(acc.numpy(), _first_stage_acc_ref(jp, q, x))
    want = np.asarray(jp.apply_head(jp.bind_head_params(q), counts))
    got = pp.apply_head(tq, torch.from_numpy(counts)).numpy()
    assert got.shape == want.shape == (3,) + pp.head_out_shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    par = quant.logit_parity(want, got)
    assert par == jquant.logit_parity(want, got) and par["top1_agreement"] == 1.0


# ---------------------------------------------------------------------------
# the int8 bucket transfer
# ---------------------------------------------------------------------------


def test_transfer_lut_bit_equal_to_reference(bucket_model, port_model):
    want = j_ops._transfer_lut(bucket_model, j_kernel._bucket_tables(bucket_model))[0]
    got = ops._transfer_lut(conv_tables(port_model, ADCConfig(), 75, torch.device("cpu")))
    assert got.dtype == np.float32 and got.shape == (256, 11)
    np.testing.assert_array_equal(got, want)


def test_basis_int8_transfer_counts_match_reference(bucket_model, port_model):
    spec_j = JFPCASpec(image_h=H, image_w=H, out_channels=4, kernel=5, stride=5)
    spec = fpca.FPCASpec(image_h=H, image_w=H, out_channels=4, kernel=5, stride=5)
    rng = np.random.default_rng(7)
    frames = np.concatenate([rng.uniform(0, 1, (6, H, H, 3)),
                             np.stack([np.full((H, H, 3), v) for v in np.linspace(0, 1, 6)])]).astype(np.float32)
    bn = rng.integers(0, 16, 4).astype(np.float32)
    want = np.asarray(j_ops.make_fpca_conv_executable(bucket_model, spec=spec_j, impl="basis", transfer="int8")(
        frames, _kernel(), bn))
    run = ops.make_fpca_conv_executable(port_model, spec=spec, impl="basis", transfer="int8", device="cpu")
    got = run(torch.from_numpy(frames), torch.from_numpy(_kernel()), torch.from_numpy(bn)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.05
    f32 = ops.make_fpca_conv_executable(port_model, spec=spec, impl="basis", device="cpu")
    assert np.abs(f32(torch.from_numpy(frames), torch.from_numpy(_kernel()), torch.from_numpy(bn)).numpy()
                  - got).max() <= 1.0
    keep = np.zeros((12, 4, 4), bool)
    keep[:, 1:3] = True
    masked = ops.make_fpca_conv_executable(port_model, spec=spec, impl="basis", transfer="int8", device="cpu",
                                           m_bucket=128)(torch.from_numpy(frames), torch.from_numpy(_kernel()),
                                                         torch.from_numpy(bn), torch.from_numpy(keep))
    np.testing.assert_array_equal(masked.numpy(), got * keep[..., None])


def test_only_basis_lowers_the_int8_transfer(port_model):
    spec = fpca.FPCASpec(image_h=H, image_w=H, out_channels=4, kernel=5, stride=5)
    with pytest.raises(ValueError, match=r"transfer='int8' is only lowered by the basis impl \(got impl='cuda'\)"):
        ops.make_fpca_conv_executable(port_model, spec=spec, impl="cuda", transfer="int8", device="cpu")
    with pytest.raises(ValueError, match="only lowered by the basis impl"):
        fpca.get_backend("cuda").make_executable(port_model, spec=spec, transfer="int8", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown transfer"):
        ops.make_fpca_conv_executable(port_model, spec=spec, impl="basis", transfer="int4", device="cpu")
    assert [fpca.get_backend(b).quant_transfer for b in ("cuda", "basis", "reference")] == [False, True, False]


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_other_backends_serve_the_f32_transfer_under_an_int8_head(port_model, backend):
    pp = _program(fpca)
    hp = pp.replace(precision="f32").init_head(torch.Generator().manual_seed(0), device="cpu")
    frames = np.random.default_rng(11).uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    m8 = fpca.compile(pp, backend=backend, device="cpu", weights=_kernel(), head_params=hp, model=port_model)
    m32 = fpca.compile(pp.replace(precision="f32"), backend=backend, device="cpu", weights=_kernel(),
                       head_params=hp, model=port_model)
    c8 = m8.run_frontend_weighted(m8.kernel, m8.bn_offset, frames)
    torch.testing.assert_close(c8, m32.run_frontend_weighted(m32.kernel, m32.bn_offset, frames), rtol=0, atol=0)
    torch.testing.assert_close(m8.run(frames), m8.head_logits(c8), rtol=0, atol=0)
    basis = fpca.compile(pp, device="cpu", weights=_kernel(), head_params=hp, model=port_model)
    assert (m8._frontend_transfer(), basis._frontend_transfer()) == ("f32", "int8")
    cb = basis.run_frontend_weighted(basis.kernel, basis.bn_offset, frames)
    torch.testing.assert_close(basis.run(frames), basis.head_logits(cb), rtol=0, atol=0)
    assert float((cb - c8).abs().max()) <= 1.0


def test_int8_reprogram_builds_nothing(port_model):
    pp = _program(fpca, **HEADS["fpca_resnet"])
    f32 = pp.replace(precision="f32")
    frames = np.random.default_rng(13).uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    m = fpca.compile(pp, device="cpu", weights=_kernel(),
                     head_params=f32.init_head(torch.Generator().manual_seed(0), device="cpu"), model=port_model)
    block = np.zeros((3, 3), bool)
    block[1, 1] = True
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, frames)
    before = (m.run(frames), m.run(frames, block_mask=block))
    misses = m.cache_info().misses
    hp2 = quant.quantize_head_params(pp, f32.init_head(torch.Generator().manual_seed(42), device="cpu"),
                                     sample_counts=counts)
    m.reprogram(_kernel() * 0.7, head_params=hp2)
    after = (m.run(frames), m.run(frames, block_mask=block))
    assert m.cache_info().misses == misses
    assert not torch.equal(before[0], after[0])
    assert m.head_params["stem"]["w_q"].dtype == torch.int8
