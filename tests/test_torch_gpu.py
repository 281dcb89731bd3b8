"""On-card checks of the port's CUDA kernels; each skips on a host without a
CUDA device.  The tests import only the port, so they run on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, each kernel against its plain PyTorch version on the card:
- fpca_conv: at most 1 ADC count and fewer than 5% of counts off (sums in
  another order can cross a round-half boundary); padding rows of a
  region-skip bucket are exact zeros.  The tensor-core design holds the
  same limit: it splits each f32 operand into three bf16 parts and runs six
  passes, within the f32 spread of the plain version in its host emulation
  (tests/test_torch_fpca_tc.py).
- flash attention: float32 within 1e-4 (f32 sums in another order); bf16
  and fp16 within one unit in the last place of the output type
  (rtol 2**-7 resp. 2**-10, plus 1e-4): both sides compute in f32 and round
  once, so two f32 results a few ulp apart may round to neighbours.  The
  bf16 tensor-core design holds the same limit: its s products are exact
  in f32 and its split p keeps p to about 2**-17.
- SSD intra-chunk: max|diff| <= 2e-5 * max|want| (f32 sums of up to 128
  products taken in another order; the tensor-core design splits each f32
  operand into three bf16 parts and runs six passes, ~5e-7 in its host
  emulation, tests/test_torch_ssd_tc.py).
- flash backward (dQ, dK/dV) and the forward's LSE, normwise against the
  plain version: float32 max|diff| <= 1e-5 * max|want| (f32 sums over up to
  G x S terms in another order); bf16 within two bf16 ulps of max|want|
  (both sides compute in f32 and round each gradient once).
- the dense smoke training step, card vs host (f32): loss within 1e-5,
  every gradient leaf within 1e-4 of its max|want|.
- the int8 head's accumulators (``quant_bank_dot``, ``conv2d_int8_acc``):
  equal to the host's bit for bit (integer sums below 2**24 are exact in
  f32 in any order); ``fused_patched_logits`` equal to ``patched_logits``
  row by row.
- fpca_conv with a device row count ``n_rows``: rows below it within the
  fpca limit of the plain version and bit-equal to the launch without it
  (rows are independent), rows at or past it exact zeros, for both designs.
- segments: a segment replayed from its CUDA graph equal to the same body
  run eagerly on the card, and to per-tick ``stream()``, bit for bit (the
  same kernels on the same inputs, in the same order).
- the FPCA training path: ``fpca_forward(backend="cuda")`` one
  tensor-core launch within the fpca limit of ``backend="basis"``; one
  training step of the example's network and ``calibrate_gain``, card vs
  host: loss, grad norm and gain within 1e-5, parameters within 1e-4 of
  max|value| (f32 sums in another order).
- multi-camera serving: a stacked C = 16 fan-out launch (SIMT design)
  within the fpca limit of the plain version and of each config's
  tensor-core launch, and bit for bit each config's own SIMT launch (one
  design rounds one way); server cameras at depth 2 and segments of two
  streams interleaved on one shared handle equal each stream served alone
  through its own handle, bit for bit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import fpca
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.fpca_sim import calibrate_gain, fpca_forward
from repro_torch.core.frontend import FPCAFrontend
from repro_torch.data.pipeline import SyntheticVWW
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.kernels.flash_attention.bwd import (
    flash_attention_bwd_cuda,
    flash_attention_dkdv_cuda,
    flash_attention_dq_cuda,
)
from repro_torch.kernels.flash_attention.bwd_ref import attention_delta, flash_attention_bwd_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.fpca_conv.kernel import (
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    weight_planes,
)
from repro_torch.kernels.fpca_conv import kernel as fpca_kernel
from repro_torch.kernels.fpca_conv.kernel import design as fpca_design
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
from repro_torch.models import quant, ssm
from repro_torch.models.attention import FlashAttention, attend_blockwise
from repro_torch.models.transformer import forward_decode, forward_prefill, forward_train, init_model
from repro_torch.training.tree import tree_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(cuda):
    return fit_bucket_model(n_pixels=75, device=cuda)


def _inputs(m: int, n: int, c: int, dev: torch.device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    patches = torch.rand((m, n), generator=g).to(dev)
    w = torch.rand((n, c), generator=g).to(dev)
    bn = torch.randint(0, 30, (c,), generator=g).float().to(dev)
    return patches, w, w.roll(1, dims=1), bn


@pytest.mark.parametrize("m,n,c,chosen", [
    (1, 75, 1, "wgmma"), (127, 75, 8, "wgmma"), (129, 75, 13, "simt"), (5000, 75, 16, "simt"),
    (300, 27, 8, "wgmma"), (300, 48, 5, "wgmma"),
    (1000, 75, 8, "wgmma"),     # a ragged last tile (7 full tiles and 104 rows)
    (100, 75, 8, "wgmma"),      # fewer rows than a tile
    (300, 81, 8, "simt"),       # more pixel slots than the padded K
])
@pytest.mark.parametrize("bits", [8, 16])
def test_kernel_matches_plain_version(cuda, model, m, n, c, chosen, bits):
    """Ragged rows and channel tiles, odd and even pixel counts; each case
    takes the design it names."""
    _check_kernel(cuda, model, m, n, c, chosen, bits)


def test_kernel_matches_plain_version_at_the_served_size(cuda, model):
    """M = 147,456 windows (fpca_cnn at batch 256: many tiles per persistent
    block) at the served 8-bit ADC.  At 16 bits these uniform inputs put
    both designs 2 counts off the plain version on a few counts (on an
    H100): the two phases' f32 spreads add there, whichever design
    computes them."""
    _check_kernel(cuda, model, 147456, 75, 8, "wgmma", 8)


def _check_kernel(cuda, model, m, n, c, chosen, bits):
    patches, w_pos, w_neg, bn = _inputs(m, n, c, cuda, seed=m + n + c)
    tables = conv_tables(model, ADCConfig(bits=bits), n, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    before, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    got = fpca_conv_cuda(patches, planes, tables, bn)
    want = fpca_conv_basis(patches, planes, tables, bn)
    torch.cuda.synchronize()
    assert fpca_conv_cuda.launches == before + 1
    assert fpca_conv_cuda.designs == {**designs, chosen: designs[chosen] + 1}
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.05
    valid = (torch.arange(m, device=cuda) % 4 != 1).float()
    got_v = fpca_conv_cuda(patches, planes, tables, bn, row_valid=valid)
    assert bool((got_v[valid == 0] == 0).all())
    assert torch.equal(got_v[valid == 1], got[valid == 1])


@pytest.mark.parametrize("cut,chosen", [(1, "simt"), (4, "wgmma")])
def test_kernel_reads_a_patch_matrix_that_starts_inside_an_allocation(cuda, model, cut, chosen):
    """Rows cut from the front of a wider matrix: a start 300 bytes in is
    not 16-byte aligned and goes to the SIMT design, one 1200 bytes in is
    and takes the tensor-core design; both agree with the plain version."""
    patches, w_pos, w_neg, bn = _inputs(777 + cut, 75, 8, cuda, seed=cut)
    patches = patches[cut:]
    tables = conv_tables(model, ADCConfig(), 75, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    assert fpca_design(patches, tables, 8) == chosen
    designs = dict(fpca_conv_cuda.designs)
    got = fpca_conv_cuda(patches, planes, tables, bn)
    want = fpca_conv_basis(patches, planes, tables, bn)
    torch.cuda.synchronize()
    assert fpca_conv_cuda.designs == {**designs, chosen: designs[chosen] + 1}
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05


@pytest.mark.parametrize("m", [100, 36864])
def test_tensor_core_kernel_is_deterministic_and_keeps_real_rows_exact(cuda, model, m):
    """Two launches are bit-equal; with row_valid, padding rows are exact
    zeros and real rows bit-equal to the launch without it."""
    patches, w_pos, w_neg, bn = _inputs(m, 75, 8, cuda, seed=m)
    tables = conv_tables(model, ADCConfig(), 75, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    assert fpca_design(patches, tables, 8) == "wgmma"
    first = fpca_conv_cuda(patches, planes, tables, bn)
    assert torch.equal(fpca_conv_cuda(patches, planes, tables, bn), first)
    valid = (torch.rand(m, generator=torch.Generator().manual_seed(m)) < 0.3).float().to(cuda)
    got_v = fpca_conv_cuda(patches, planes, tables, bn, row_valid=valid)
    torch.cuda.synchronize()
    assert torch.equal(got_v[valid == 0], torch.zeros_like(got_v[valid == 0]))
    assert torch.equal(got_v[valid == 1], first[valid == 1])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, model):
    patches, w_pos, w_neg, bn = _inputs(64, 75, 8, cuda)
    tables = conv_tables(model, ADCConfig(), 75, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    with pytest.raises(ValueError, match="float32"):
        fpca_conv_cuda(patches.double(), planes, tables, bn)
    with pytest.raises(ValueError, match="contiguous"):
        fpca_conv_cuda(torch.rand(75, 64, device=cuda).T, planes, tables, bn)
    with pytest.raises(ValueError, match="pixel slots"):
        fpca_conv_cuda(patches[:, :50].contiguous(), planes, tables, bn)


@pytest.mark.parametrize("arch", ["fpca_resnet", "fpca_detect"])
def test_zoo_models_launch_the_tensor_core_kernel_and_match_basis(cuda, model, arch):
    """The zoo's archs at their defaults (120x120x3 frames, 8 channels):
    every launch on the tensor-core design, counts within the fpca limit of
    ``basis`` on the card, ``run`` equal to head(frontend) bit for bit."""
    prog = fpca.build_model({"arch": arch})
    g = torch.Generator().manual_seed(2)
    kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
    head = prog.init_head(g, device=cuda)
    frames = torch.rand((3, 120, 120, 3), generator=g).to(cuda)
    m = fpca.compile(prog, weights=kernel, head_params=head, model=model)
    b = fpca.compile(prog, backend="basis", device=cuda, weights=kernel, head_params=head, model=model)
    before, wgmma = fpca_conv_cuda.launches, fpca_conv_cuda.designs["wgmma"]
    out = m.run(frames)
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, frames)
    assert fpca_conv_cuda.launches == before + 2 and fpca_conv_cuda.designs["wgmma"] == wgmma + 2
    raw = m.head_logits(counts)
    if arch == "fpca_detect":
        assert isinstance(out, fpca.Detections) and tuple(out.scores.shape) == (3, 24, 24, 2)
        assert tuple(out.boxes.shape) == (3, 24, 24, 4)
        out = torch.cat([out.scores, out.boxes], -1)
    else:
        assert tuple(out.shape) == (3, 2)
    assert torch.equal(out, raw) and bool(torch.isfinite(raw).all())
    want = b.run_frontend_weighted(b.kernel, b.bn_offset, frames)
    diff = (counts - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05


@pytest.mark.parametrize("m,k,n", [(2, 64, 5), (3, 1500, 7), (256, 4608, 64)])
def test_quant_bank_dot_on_the_card_equals_the_host(cuda, m, k, n):
    """K = 4608 is the int8 fpca_cnn dense stage (24 x 24 x 8 counts)."""
    g = torch.Generator().manual_seed(k)
    x_q = torch.randint(-127, 128, (m, k), generator=g).float()
    w_q = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8)
    want = quant.quant_bank_dot(x_q, w_q)
    got = quant.quant_bank_dot(x_q.to(cuda), w_q.to(cuda))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert torch.equal(want.long(), x_q.long() @ w_q.long())


@pytest.mark.parametrize("c_in,stride,padding", [(16, 1, "SAME"), (8, 1, "SAME"), (130, 2, "VALID")])
def test_conv2d_int8_on_the_card_equals_the_host(cuda, c_in, stride, padding):
    """3x3 SAME over 16 channels is the fpca_resnet residual branch; 130
    channels take the chunked reduction (1170 terms)."""
    g = torch.Generator().manual_seed(c_in)
    x = torch.randn((4, 24, 24, c_in), generator=g) * 3
    qp = {"w_q": torch.randint(-127, 128, (16, 3, 3, c_in), generator=g).to(torch.int8),
          "w_scale": torch.rand(16, generator=g) * 0.01, "b": torch.randn(16, generator=g),
          "x_scale": x.abs().max() / 127.0}
    want = quant.conv2d_int8_acc(qp, x, stride, padding)
    got = quant.conv2d_int8_acc({k: v.to(cuda) for k, v in qp.items()}, x.to(cuda), stride, padding)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_fused_patched_logits_rows_equal_patched_logits_on_the_card(cuda, model):
    prog = fpca.build_model({"arch": "fpca_resnet"})
    g = torch.Generator().manual_seed(4)
    heads = [prog.bind_head_params(prog.init_head(g, device=cuda)) for _ in range(3)]
    m = fpca.compile(prog, weights=torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3,
                     head_params=heads[0], model=model)
    counts = torch.randint(0, 256, (3, 24, 24, 8), generator=g).float().to(cuda)
    prev = torch.randint(0, 256, (3, 24, 24, 8), generator=g).float().to(cuda)
    keep = (torch.rand((3, 24, 24), generator=g) < 0.3).to(cuda)
    stacked = {n: {k: torch.stack([h[n][k] for h in heads]) for k in heads[0][n]} for n in heads[0]}
    fused, eff = m.fused_patched_logits(stacked, counts, prev, keep)
    for i, h in enumerate(heads):
        want, want_eff = m.patched_logits(counts[i:i + 1], prev[i:i + 1], keep[i:i + 1], h)
        assert torch.equal(fused[i], want[0]) and torch.equal(eff[i], want_eff[0])


def test_compiled_model_launches_the_kernel_and_matches_basis(cuda, model):
    spec = fpca.FPCASpec(image_h=48, image_w=48, out_channels=8, kernel=5, stride=5)
    prog = fpca.FPCAModelProgram(frontend=fpca.FPCAProgram(spec=spec),
                                 head=(fpca.DenseSpec(16, activation="relu"), fpca.DenseSpec(3)))
    g = torch.Generator().manual_seed(1)
    kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
    head = prog.init_head(g, device=cuda)
    frames = torch.rand((5, 48, 48, 3), generator=g).to(cuda)
    m = fpca.compile(prog, weights=kernel, head_params=head, model=model)
    b = fpca.compile(prog, backend="basis", device=cuda, weights=kernel, head_params=head, model=model)
    assert m.backend.name == "cuda" and m.device.type == "cuda"
    before, wgmma = fpca_conv_cuda.launches, fpca_conv_cuda.designs["wgmma"]
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, frames)
    block = torch.zeros((6, 6), dtype=torch.bool)
    block[2:4, 1:5] = True
    logits = m.run(frames, block_mask=block)
    assert fpca_conv_cuda.launches == before + 2
    assert fpca_conv_cuda.designs["wgmma"] == wgmma + 2   # dense and compacted, both on the tensor cores
    want = b.run_frontend_weighted(b.kernel, b.bn_offset, frames)
    diff = (counts - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05
    assert logits.shape == (5, 3) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("n_rows", [0, 1, 127, 128, 129, 576])
def test_kernel_walks_the_row_count_it_reads_from_the_device(cuda, model, tensor_cores, n_rows):
    """M = 576 (fpca_cnn at batch 1).  Rows below the device count equal the
    launch without a count bit for bit and the plain version within the
    fpca limit; rows at or past it are exact zeros; a zero count gives all
    zeros.  The SIMT design is launched through the C entry point."""
    m = 576
    patches, w_pos, w_neg, bn = _inputs(m, 75, 8, cuda, seed=n_rows)
    tables = conv_tables(model, ADCConfig(), 75, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    count = torch.tensor([n_rows], dtype=torch.int32, device=cuda)
    full = torch.empty((m, 8), device=cuda)
    got = torch.full((m, 8), float("nan"), device=cuda)
    assert fpca_kernel._launch(patches, planes, tables, bn, None, full, tensor_cores=tensor_cores) == 0
    assert fpca_kernel._launch(patches, planes, tables, bn, None, got, tensor_cores=tensor_cores,
                               n_rows=count) == 0
    want = fpca_conv_basis(patches, planes, tables, bn, n_rows=count)
    torch.cuda.synchronize()
    assert torch.equal(got[:n_rows], full[:n_rows])
    assert torch.equal(got[n_rows:], torch.zeros_like(got[n_rows:]))
    assert torch.equal(want[n_rows:], torch.zeros_like(want[n_rows:]))
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05
    if tensor_cores:
        before = fpca_conv_cuda.launches
        assert torch.equal(fpca_conv_cuda(patches, planes, tables, bn, n_rows=count), got)
        assert fpca_conv_cuda.launches == before + 1


def _segment_model(model, cuda, precision="f32"):
    spec = fpca.FPCASpec(image_h=48, image_w=48, out_channels=8, kernel=5, stride=5)
    gate = fpca.DeltaGateConfig(threshold=0.02, hysteresis=0, keyframe_interval=7)
    prog = fpca.FPCAModelProgram(frontend=fpca.FPCAProgram(spec=spec, gate=gate), precision=precision,
                                 head=(fpca.DenseSpec(16, activation="relu"), fpca.DenseSpec(3)))
    g = torch.Generator().manual_seed(3)
    kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
    return fpca.compile(prog, device=cuda, weights=kernel, head_params=prog.init_head(g, device=cuda), model=model)


def _scene(k: int, seed: int = 0) -> torch.Tensor:
    """48x48 frames: a moving square over a fixed background, two repeated
    (all-skipped) stretches."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((48, 48, 3), generator=g)
    frames = base.repeat(k, 1, 1, 1)
    for t in range(k):
        c = (5 * t) % 40
        frames[t, c:c + 8, c:c + 8] = 1.0
    frames[4:7] = frames[3]
    frames[k - 2:] = frames[k - 3]
    return frames


@pytest.mark.parametrize("early_exit,precision", [(None, "f32"), (2, "f32"), (None, "int8")])
def test_captured_segment_equals_its_eager_run_and_the_per_tick_loop(cuda, model, early_exit, precision):
    """The graph replay of a gated model segment (f32 and int8 heads)
    against the same body run eagerly on the card and against
    ``stream()``: counts, masks, logits and the carry bit for bit; the
    first call captures, later calls replay."""
    from repro_torch.fpca.backends import _CapturedSegment

    m = _segment_model(model, cuda, precision)
    frames = _scene(12)
    seg = m.run_segment(frames, early_exit=early_exit)
    key = next(k for k in m.cache_info(verbose=True).resident if "segment" in k)
    run = m._cache._entries[key].__wrapped__
    assert isinstance(run, _CapturedSegment) and run.capture_ms is not None
    again = m.run_segment(frames, early_exit=early_exit)
    assert torch.equal(again.counts, seg.counts) and torch.equal(again.logits, seg.logits)
    state = m._fresh_segment_state(m.program.gate.hysteresis, True)
    g = m.program.gate
    gate_args = (torch.tensor(g.threshold, device=cuda), torch.tensor(g.hysteresis, dtype=torch.int32, device=cuda),
                 torch.tensor(g.keyframe_interval, dtype=torch.int32, device=cuda))
    outs, carry = run._body(frames.to(cuda), m.kernel, m.bn_offset, m.head_params, gate_args,
                            state.carry(True, cuda))
    assert torch.equal(outs["counts"], seg.counts) and torch.equal(outs["logits"], seg.logits)
    assert torch.equal(outs["kept"].cpu().long(), torch.as_tensor(seg.kept_windows))
    for a, b in zip(carry, (seg.state.has_prev, seg.state.prev_eff, seg.state.age, seg.state.frame_idx,
                            seg.state.eff, seg.state.logits)):
        assert torch.equal(a, b)
    ticks = list(m.stream(frames[: seg.ticks], controller=None))
    assert len(ticks) == seg.ticks == (12 if early_exit is None else seg.ticks)
    for t, r in enumerate(ticks):
        assert (seg.counts[t].cpu().numpy() == r.counts).all()
        assert (seg.block_masks[t] == r.block_mask).all()
        assert (seg.logits[t].cpu().numpy() == r.logits).all()
    if early_exit is not None:
        assert seg.ticks < 12 and (seg.kept_windows[seg.ticks - 2: seg.ticks] == 0).all()
        assert torch.equal(seg.counts[seg.ticks:], torch.zeros_like(seg.counts[seg.ticks:]))


def test_segment_reprogram_and_servo_step_build_nothing(cuda, model):
    """A weight rewrite and a new threshold between segments replay the same
    graph, and the replay follows the new values (equal to a fresh handle's
    first segment under them)."""
    m = _segment_model(model, cuda)
    frames = _scene(8, seed=1)
    first = m.run_segment(frames, m_bucket=16)
    misses = m.cache_info().misses
    g = torch.Generator().manual_seed(9)
    kernel = torch.randn(m.program.kernel_shape, generator=g) * 0.3
    m.reprogram(kernel)
    gate = dataclasses.replace(m.program.gate, threshold=0.05)
    seg = m.run_segment(frames, m_bucket=16, gate=gate)
    assert m.cache_info().misses == misses
    fresh = _segment_model(model, cuda)
    fresh.reprogram(kernel)
    want = fresh.run_segment(frames, m_bucket=16, gate=gate)
    assert torch.equal(seg.counts, want.counts) and torch.equal(seg.logits, want.logits)
    assert not torch.equal(seg.counts, first.counts)


# ---------------------------------------------------------------------------
# multi-camera serving: the stacked fan-out launch, the server at depth 2,
# segments of two streams on one shared handle
# ---------------------------------------------------------------------------


def _serving_pipeline(cuda, model):
    """fe0 / fe1: two 8-channel frontend configs of one spec; cam: a model
    config on the same spec; 48x48 frames, 81 windows a frame."""
    from repro_torch.serving import FPCAPipeline

    spec = fpca.FPCASpec(image_h=48, image_w=48, out_channels=8, kernel=5, stride=5)
    pipe = FPCAPipeline(model, device=cuda)
    g = torch.Generator().manual_seed(11)
    for name in ("fe0", "fe1"):
        pipe.register(name, spec, torch.randn((8, 5, 5, 3), generator=g) * 0.3,
                      torch.randint(0, 24, (8,), generator=g).float())
    prog = fpca.FPCAModelProgram(frontend=fpca.FPCAProgram(spec=spec),
                                 head=(fpca.DenseSpec(16, activation="relu"), fpca.DenseSpec(3)))
    pipe.register("cam", prog, torch.randn((8, 5, 5, 3), generator=g) * 0.3, head_params=prog.init_head(g, device=cuda))
    return pipe


def _own_handle(pipe, name, model, cuda):
    cfg = pipe._configs[name]
    kw = dict(device=cuda, model=model, weights=cfg.kernel, bn_offset=cfg.bn_offset)
    if isinstance(cfg, fpca.ProgrammedModel):
        return fpca.compile(cfg.model, head_params=cfg.head_params, **kw)
    return fpca.compile(cfg.program, **kw)


def test_stacked_sixteen_channel_launch_takes_simt_and_matches(cuda, model, monkeypatch):
    """A fan-out of two 8-channel configs is one C = 16 launch on the SIMT
    design: within the fpca limit of the plain version and of each config's
    own tensor-core launch, and bit for bit each config's own launch when
    that takes the SIMT design too."""
    pipe = _serving_pipeline(cuda, model)
    frames = _scene(6).to(cuda)
    keep = (torch.rand((6, 9, 9), generator=torch.Generator().manual_seed(2)) < 0.5).numpy()
    before, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    got = pipe.run_config_batch(["fe0", "fe1"], frames, keep)
    torch.cuda.synchronize()
    assert fpca_conv_cuda.launches == before + 1 and fpca_conv_cuda.designs["simt"] == designs["simt"] + 1
    plain = fpca.compile(pipe._configs["fe0"].program.replace(out_channels=16), backend="basis", device=cuda,
                         model=model, weights=torch.cat([pipe._configs[n].kernel for n in ("fe0", "fe1")]),
                         bn_offset=torch.cat([pipe._configs[n].bn_offset for n in ("fe0", "fe1")]))
    diff = (got - plain.run_weighted(plain.kernel, plain.bn_offset, frames, keep)).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05
    for i, name in enumerate(("fe0", "fe1")):
        own = _own_handle(pipe, name, model, cuda)
        tc = own.run_weighted(own.kernel, own.bn_offset, frames, keep)
        d = (got[..., 8 * i:8 * i + 8] - tc).abs()
        assert float(d.max()) <= 1.0 and float((d > 0).float().mean()) < 0.05
        monkeypatch.setattr(fpca_kernel, "TC_MAX_CHANNELS", 0)
        simt = own.run_weighted(own.kernel, own.bn_offset, frames, keep)
        monkeypatch.undo()
        assert torch.equal(got[..., 8 * i:8 * i + 8], simt)


def test_four_camera_server_at_depth_two_equals_each_stream(cuda, model):
    """Four cameras of one model config on one server, double-buffered:
    each camera's counts, masks and logits equal its own handle's
    ``stream()`` bit for bit; the batched gate equals the solo gate."""
    from repro_torch.core import gating
    from repro_torch.serving import StreamServer

    pipe = _serving_pipeline(cuda, model)
    gate = fpca.DeltaGateConfig(threshold=0.02, hysteresis=0, keyframe_interval=7)
    server = StreamServer(pipe, gate, depth=2)
    scenes = {f"c{i}": _scene(12, seed=i) for i in range(4)}
    for sid in scenes:
        server.add_stream(sid, "cam")
    results = [r for rs in server.run({sid: f[t] for sid, f in scenes.items()} for t in range(12)) for r in rs]
    own = _own_handle(pipe, "cam", model, cuda)
    for sid, frames in scenes.items():
        mine = [r for r in results if r.stream_id == sid]
        solo = list(own.stream(frames, gate=gate, controller=None))
        assert len(mine) == len(solo) == 12
        for a, b in zip(mine, solo):
            assert (a.counts == b.counts).all() and (a.block_mask == b.block_mask).all()
            assert (a.logits == b.logits).all() and a.kept_windows == b.kept_windows
    kern = gating.host_gate_kernels(pipe._configs["cam"].spec, cuda)
    prev = gating.effective_frame(torch.stack([f[0] for f in scenes.values()]).to(cuda), pipe._configs["cam"].spec)
    cur = torch.stack([f[1] for f in scenes.values()]).to(cuda)
    effs, deltas = kern.step_batch(prev, cur)
    for i in range(4):
        e, d = kern.step(prev[i], cur[i])
        assert torch.equal(e, effs[i]) and torch.equal(d, deltas[i])


def test_two_streams_interleave_segments_on_one_shared_handle(cuda, model):
    """Two streams of one config share one captured segment graph; their
    segments interleaved equal each stream's own chain of segments on a
    fresh handle, bit for bit."""
    from repro_torch.serving import StreamServer

    pipe = _serving_pipeline(cuda, model)
    gate = fpca.DeltaGateConfig(threshold=0.02, hysteresis=0, keyframe_interval=7)
    server = StreamServer(pipe, gate)
    scenes = {"a": _scene(12, seed=5), "b": _scene(12, seed=6)}
    for sid in scenes:
        server.add_stream(sid, "cam")
    gens = {sid: server.serve_segments(sid, f, segment_length=4) for sid, f in scenes.items()}
    got = {sid: [] for sid in scenes}
    for _ in range(3):
        for sid, gen in gens.items():
            got[sid].extend(next(gen) for _ in range(4))
    for sid, frames in scenes.items():
        own = _own_handle(pipe, "cam", model, cuda)
        state = None
        for s in range(3):
            seg = own.run_segment(frames[4 * s:4 * s + 4], state=state, gate=gate)
            state = seg.state
            for t in range(4):
                r = got[sid][4 * s + t]
                assert (seg.counts[t].cpu().numpy() == r.counts).all()
                assert (seg.block_masks[t] == r.block_mask).all()
                assert (seg.logits[t].cpu().numpy() == r.logits).all()


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

_FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2**-7, 1e-4), torch.float16: (2**-10, 1e-4)}


def _fwd_designs_after(fn):
    before = dict(flash_attention_cuda.designs)
    result = fn()
    return result, {k: flash_attention_cuda.designs[k] - before[k] for k in before}


def _qkv(b, sq, sk, h, kv, d, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g).to(dev, dtype)
    k = torch.randn((b, sk, kv, d), generator=g).to(dev, dtype)
    v = torch.randn((b, sk, kv, d), generator=g).to(dev, dtype)
    return q, k, v


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal,window",
    [
        (1, 256, 256, 4, 4, 64, True, None),     # MHA causal, whole tiles
        (2, 200, 200, 8, 2, 32, True, None),     # GQA, ragged
        (1, 256, 256, 4, 1, 64, False, None),    # MQA, bidirectional
        (1, 300, 300, 4, 2, 128, True, 64),      # sliding window
        (2, 130, 130, 4, 4, 112, True, None),    # the served head dim, ragged
        (1, 77, 333, 2, 1, 16, False, 50),       # Sq != Sk, window without causal
        (1, 333, 77, 2, 2, 112, True, None),     # Sq > Sk, causal
        (1, 150, 150, 4, 2, 40, True, None),     # D = 40 (not a multiple of 16): SIMT in bf16 too
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernel_matches_plain_version(cuda, b, sq, sk, h, kv, d, causal, window, dtype):
    q, k, v = _qkv(b, sq, sk, h, kv, d, dtype, cuda, seed=sq + d)
    before, designs_before = flash_attention_cuda.launches, dict(flash_attention_cuda.designs)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    chosen = _expected_design(dtype, d)
    assert flash_attention_cuda.designs[chosen] == designs_before[chosen] + 1
    want = attend_blockwise(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (b, sq, h, d)
    rtol, atol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.bfloat16, 64), (torch.bfloat16, 112)])
def test_flash_kernel_reads_strided_heads(cuda, dtype, d):
    """q/k/v as column slices of one packed projection; in bf16 every row
    stays 16-byte aligned, so the wgmma design takes them."""
    qkv = torch.randn((2, 150, 3 * 4 * d), device=cuda, dtype=dtype)
    q, k, v = (t.reshape(2, 150, 4, d) for t in qkv.split(4 * d, dim=-1))
    assert not q.is_contiguous()
    got, took = _fwd_designs_after(lambda: flash_attention_cuda(q, k, v))
    assert took[_expected_design(dtype, d)] == 1
    want = attend_blockwise(q, k, v)
    rtol, atol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


FWD_TC_GRID = [
    (1, 256, 256, 4, 4, 64, True, None),       # MHA causal, whole tiles, D = 64
    (2, 300, 300, 16, 8, 128, True, None),     # the trained GQA heads, ragged Sq
    (2, 200, 200, 4, 4, 112, True, None),      # the served head dim (padded to 128), ragged
    (1, 333, 333, 4, 2, 112, True, 100),       # sliding window, ragged
    (1, 130, 130, 16, 8, 128, False, None),    # bidirectional
    (1, 77, 333, 2, 1, 64, False, 50),         # Sq != Sk, window without causal
    (1, 333, 77, 2, 2, 128, True, None),       # Sq > Sk, causal
    (1, 1100, 1100, 16, 8, 128, True, 300),    # many tiles, heaviest first, window
    (1, 700, 700, 8, 2, 80, True, 256),        # danube's head dim (padded to 128) under a window
    (1, 300, 700, 16, 16, 64, False, None),    # seamless cross-attention: Sq != Sk, Sk ragged, D = 64
    (1, 700, 700, 16, 16, 64, False, None),    # seamless encoder: bidirectional, ragged
    (1, 600, 600, 24, 8, 64, True, None),      # granite's GQA heads, D = 64
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FWD_TC_GRID)
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_tensor_core_kernel_matches_plain_version(cuda, b, sq, sk, h, kv, d, causal, window, return_lse):
    """bf16 with D % 16 == 0 takes the wgmma design and stays within one
    bf16 ulp of the plain version (its LSE within 1e-5 of max|value|)."""
    q, k, v = _qkv(b, sq, sk, h, kv, d, torch.bfloat16, cuda, seed=sq + d + 1)
    got, took = _fwd_designs_after(
        lambda: flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=return_lse))
    assert took == {"wgmma": 1, "simt": 0}
    want, lse_r = flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    out = got[0] if return_lse else got
    assert out.dtype == torch.bfloat16 and out.shape == (b, sq, h, d)
    torch.testing.assert_close(out.float(), want.float(), rtol=2**-7, atol=1e-4)
    if return_lse:
        assert got[1].shape == (b, h, sq) and got[1].dtype == torch.float32
        _bwd_close(got[1], lse_r, "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_is_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v = _qkv(2, 300, 300, 16, 8, 128, dtype, cuda, seed=13)
    first = flash_attention_cuda(q, k, v, window=200, return_lse=True)
    second = flash_attention_cuda(q, k, v, window=200, return_lse=True)
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse"), first, second):
        assert torch.equal(x, y), name


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="share"):
        flash_attention_cuda(q, k.half(), v)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="unit-stride"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*_qkv(1, 8, 8, 1, 1, 160, torch.float32, cuda))
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention_cuda(*_qkv(1, 8, 8, 3, 2, 32, torch.float32, cuda))


BWD_GRID = [
    (1, 192, 192, 4, 4, 32, True, None),     # MHA causal
    (2, 160, 160, 4, 2, 32, True, None),     # GQA (group sum in the block)
    (1, 128, 128, 4, 1, 64, False, None),    # MQA bidirectional
    (1, 200, 200, 2, 2, 32, True, 48),       # sliding window, ragged
    (1, 77, 333, 4, 2, 128, False, None),    # Sq != Sk, non-causal, D = 128
    (2, 300, 300, 4, 2, 128, True, None),    # the trained head dim, GQA, ragged
    (1, 160, 160, 4, 2, 96, True, None),     # D = 96: bf16 pads the head dim to 128
    (1, 150, 150, 4, 2, 40, True, None),     # D = 40 (not a multiple of 16): SIMT in bf16 too
    (1, 1024, 1024, 8, 2, 128, True, None),  # causal GQA over many tiles, heaviest first
    (1, 300, 700, 16, 16, 64, False, None),  # seamless cross-attention: Sq != Sk, Sk ragged, D = 64
    (1, 700, 700, 16, 16, 64, False, None),  # seamless encoder: bidirectional, ragged
    (1, 600, 600, 24, 8, 64, True, None),    # granite's GQA heads, D = 64
]


def _expected_design(dtype, d) -> str:
    return "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 else "simt"


def _designs() -> tuple[dict, dict]:
    return dict(flash_attention_dq_cuda.designs), dict(flash_attention_dkdv_cuda.designs)


def _bwd_close(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, name
    err, top = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    if got.dtype == torch.float32:
        tol = 1e-5 * top
    else:   # two bf16 ulps of max|want|
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert err <= tol, f"{name}: max|diff| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", BWD_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain_version(cuda, b, sq, sk, h, kv, d, causal, window, dtype):
    q, k, v = _qkv(b, sq, sk, h, kv, d, dtype, cuda, seed=sq + d)
    do = torch.randn((b, sq, h, d), generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    out_r, lse_r = attend_blockwise(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _bwd_close(lse, lse_r, "lse")
    before = (flash_attention_dq_cuda.launches, flash_attention_dkdv_cuda.launches)
    designs_before = _designs()
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_dq_cuda.launches, flash_attention_dkdv_cuda.launches) == (before[0] + 1, before[1] + 1)
    chosen = _expected_design(dtype, d)
    for was, now in zip(designs_before, _designs()):
        assert now[chosen] == was[chosen] + 1 and sum(now.values()) == sum(was.values()) + 1, (now, was)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(x, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    b, sq, sk, h, kv, d = 2, 300, 300, 4, 2, 128
    q, k, v = _qkv(b, sq, sk, h, kv, d, dtype, cuda, seed=11)
    do = torch.randn((b, sq, h, d), generator=torch.Generator().manual_seed(12)).to(cuda, dtype)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    second = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


def test_flash_bwd_kernels_read_strided_inputs(cuda):
    """q/k/v as column slices of one packed projection and a transposed dO."""
    qkv = torch.randn((2, 150, 3 * 4 * 64), device=cuda)
    q, k, v = (t.reshape(2, 150, 4, 64) for t in qkv.split(4 * 64, dim=-1))
    do = torch.randn((2, 4, 150, 64), device=cuda).transpose(1, 2)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(x, w, name)


def test_flash_bwd_tensor_core_kernels_read_strided_inputs(cuda):
    """bf16 q/k/v as column slices of one packed projection and a transposed
    dO: every row stays 16-byte aligned, so the wgmma design takes them."""
    qkv = torch.randn((2, 150, 3 * 4 * 64), device=cuda, dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 150, 4, 64) for t in qkv.split(4 * 64, dim=-1))
    do = torch.randn((2, 4, 150, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    before = _designs()
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do)
    assert [now["wgmma"] - was["wgmma"] for was, now in zip(before, _designs())] == [1, 1]
    want = flash_attention_bwd_ref(q, k, v, out, lse, do)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(x, w, name)


def test_flash_bwd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, torch.float32, cuda)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    delta = attention_delta(out, out)
    with pytest.raises(ValueError, match="dO"):
        flash_attention_dq_cuda(q, k, v, out.half(), lse, delta)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dkdv_cuda(q, k, v, out, lse.double(), delta)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_dq_cuda(q, k, v, out, lse, delta[:, :, :10])


def test_flash_attention_function_on_the_card_matches_the_host(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(2, 130, 130, 4, 2, 64, torch.float32, torch.device("cpu")))
    do = torch.randn((2, 130, 4, 64), generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad(FlashAttention.apply(q, k, v, True, None), (q, k, v), do)
    qc, kc, vc = (t.detach().to(cuda).requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(FlashAttention.apply(qc, kc, vc, True, None), (qc, kc, vc), do.to(cuda))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(x.cpu(), w, name)


def test_dense_smoke_training_on_the_card_matches_the_host(cuda):
    cfg = reduce_for_smoke(ARCHS["qwen3-1.7b"])
    host = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = _to(host, cuda)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 200), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 200), generator=g)}
    host_leaves = [p.requires_grad_() for p in tree_leaves(host)]
    card_leaves = [p.requires_grad_() for p in tree_leaves(card)]
    for remat, launches in (("none", (2, 2, 2)), ("full", (4, 2, 2))):
        want_loss, _ = forward_train(host, cfg, batch, remat=remat)
        want = torch.autograd.grad(want_loss, host_leaves)
        before = (flash_attention_cuda.launches, flash_attention_dq_cuda.launches,
                  flash_attention_dkdv_cuda.launches)
        loss, _ = forward_train(card, cfg, {k: t.to(cuda) for k, t in batch.items()}, remat=remat)
        got = torch.autograd.grad(loss, card_leaves)
        after = (flash_attention_cuda.launches, flash_attention_dq_cuda.launches,
                 flash_attention_dkdv_cuda.launches)
        assert tuple(a - b for a, b in zip(after, before)) == launches, remat
        assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-5
        for x, w in zip(got, want):
            assert float((x.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------------------
# SSD intra-chunk
# ---------------------------------------------------------------------------


def _ssd_chunk_inputs(b, nc, q, h, p, n, g, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xbar = torch.randn((b, nc, q, h, p), generator=gen).to(dev)
    Bg = torch.randn((b, nc, q, g, n), generator=gen).to(dev)
    Cg = torch.randn((b, nc, q, g, n), generator=gen).to(dev)
    cum = -torch.cumsum(torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=gen)), 2).to(dev)
    if g == 1:
        return xbar, Bg.expand(b, nc, q, h, n), Cg.expand(b, nc, q, h, n), cum
    return xbar, Bg.repeat_interleave(h // g, 3), Cg.repeat_interleave(h // g, 3), cum


def _normwise(got, want, tol=2e-5):
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize(
    "b,nc,q,h,p,n,g,chosen",
    [
        (2, 3, 128, 4, 64, 64, 1, "wgmma"),    # the served chunk and widths
        (1, 2, 128, 4, 64, 128, 1, "wgmma"),   # the wide state of mamba2-2.7b
        (1, 2, 128, 4, 64, 64, 2, "wgmma"),    # two groups (repeated, so B/C are contiguous)
        (1, 2, 64, 8, 64, 128, 1, "simt"),     # wide state, short chunk
        (2, 3, 32, 4, 16, 8, 1, "simt"),       # small dims
        (1, 2, 100, 6, 48, 40, 3, "simt"),     # ragged chunk, three groups (repeated)
        (1, 1, 16, 2, 128, 16, 1, "simt"),     # wide heads
    ],
)
def test_ssd_kernel_matches_plain_version(cuda, b, nc, q, h, p, n, g, chosen):
    xbar, Bh, Ch, cum = _ssd_chunk_inputs(b, nc, q, h, p, n, g, cuda, seed=q + p + n)
    before, designs = ssd_intra_chunk_cuda.launches, dict(ssd_intra_chunk_cuda.designs)
    y, states, decay = ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.launches == before + 1
    assert ssd_intra_chunk_cuda.designs == {**designs, chosen: designs[chosen] + 1}
    y_ref, s_ref, d_ref = ssd_intra_chunk_ref(xbar, Bh, Ch, cum)
    assert y.shape == y_ref.shape and states.shape == s_ref.shape == (b, nc, h, p, n)
    _normwise(y, y_ref)
    _normwise(states, s_ref)
    assert torch.equal(decay, d_ref)


def test_ssd_tensor_core_design_takes_misaligned_rows_to_simt(cuda):
    """The served shape with B/C rows that are not 16-byte aligned (a state
    dim cut from a wider tensor) goes to the SIMT design and still agrees."""
    xbar, Bh, Ch, cum = _ssd_chunk_inputs(1, 2, 128, 4, 64, 65, 1, cuda, seed=11)
    Bh, Ch = Bh[..., 1:], Ch[..., 1:]
    before = dict(ssd_intra_chunk_cuda.designs)
    y, states, _ = ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.designs == {**before, "simt": before["simt"] + 1}
    y_ref, s_ref, _ = ssd_intra_chunk_ref(xbar, Bh, Ch, cum)
    _normwise(y, y_ref)
    _normwise(states, s_ref)


def test_ssd_wrapper_refuses_inputs_that_need_a_gradient(cuda):
    xbar, Bh, Ch, cum = _ssd_chunk_inputs(1, 2, 128, 4, 64, 64, 1, cuda)
    before = ssd_intra_chunk_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_intra_chunk_cuda(xbar.requires_grad_(), Bh, Ch, cum)
    assert ssd_intra_chunk_cuda.launches == before
    with torch.no_grad():
        ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
    assert ssd_intra_chunk_cuda.launches == before + 1


def test_ssd_chunked_through_the_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(3)
    b, l, h, p, n = 2, 300, 4, 32, 16
    x = torch.randn((b, l, h, p), generator=gen).to(cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen) - 1).to(cuda)
    A = -torch.exp(torch.randn(h, generator=gen) * 0.5).to(cuda)
    B = torch.randn((b, l, 1, n), generator=gen).to(cuda)
    C = torch.randn((b, l, 1, n), generator=gen).to(cuda)
    s0 = torch.randn((b, h, p, n), generator=gen).to(cuda)
    before = ssd_intra_chunk_cuda.launches
    y, s = ssd_ops.ssd_chunked(x, dt, A, B, C, chunk=128, initial_state=s0)
    assert ssd_intra_chunk_cuda.launches == before + 1
    y_ref, s_ref = ssm.ssd_chunked(x, dt, A, B, C, chunk=128, initial_state=s0)
    _normwise(y, y_ref)
    _normwise(s, s_ref)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    xbar, Bh, Ch, cum = _ssd_chunk_inputs(1, 2, 32, 4, 16, 8, 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        ssd_intra_chunk_cuda(xbar.double(), Bh, Ch, cum)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_intra_chunk_cuda(xbar.transpose(3, 4).contiguous().transpose(3, 4), Bh, Ch, cum)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_intra_chunk_cuda(xbar, Bh.cpu(), Ch, cum)
    with pytest.raises(ValueError, match="unit-stride"):
        ssd_intra_chunk_cuda(xbar, Bh.transpose(3, 4).contiguous().transpose(3, 4), Ch, cum)
    with pytest.raises(ValueError, match="q <= 128"):
        ssd_intra_chunk_cuda(*_ssd_chunk_inputs(1, 1, 130, 2, 16, 8, 1, cuda))


# ---------------------------------------------------------------------------
# the FPCA training path on the card
# ---------------------------------------------------------------------------


def _train_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_fpca_cnn_torch.py"
    spec = importlib.util.spec_from_file_location("_train_fpca_cnn_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bits", [8, 4])
def test_fpca_forward_shim_launches_the_kernel_once_and_matches_basis(cuda, model, bits):
    """``fpca_forward(backend="cuda")`` (the path a deployed FPCAFrontend
    takes) is one tensor-core launch, within the fpca limit of the plain
    version (``backend="basis"``) on the same card."""
    spec = fpca.FPCASpec(image_h=60, image_w=60, out_channels=8, kernel=5, stride=5)
    g = torch.Generator().manual_seed(bits)
    images = torch.rand((4, 60, 60, 3), generator=g).to(cuda)
    kernel = (torch.randn((8, 5, 5, 3), generator=g) * 0.3).to(cuda)
    bn = torch.randint(0, 4, (8,), generator=g).float().to(cuda)
    kw = dict(model=model, adc=ADCConfig(bits=bits), mode="bucket_sigmoid", bn_offset_counts=bn)
    before, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    with pytest.warns(DeprecationWarning):
        got = fpca_forward(images, kernel, spec, backend="cuda", **kw)["counts"]
    torch.cuda.synchronize()
    assert fpca_conv_cuda.launches == before + 1
    assert fpca_conv_cuda.designs == {**designs, "wgmma": designs["wgmma"] + 1}
    with pytest.warns(DeprecationWarning):
        want = fpca_forward(images, kernel, spec, backend="basis", **kw)["counts"]
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05


def test_fpca_training_step_card_vs_host(cuda, model):
    """One AdamW step of the example's hw-aware network at smoke size (20x20
    frames, 4 channels, batch 4, 4-bit ADC, 8 NVM levels) from the same
    initial parameters: loss and grad norm within 1e-5, every parameter
    within 1e-4 of its max|value| (f32 sums in another order through the
    bucket model)."""
    ex = _train_example()
    prog = fpca.FPCAProgram(spec=fpca.FPCASpec(image_h=20, image_w=20, out_channels=4, kernel=5, stride=5),
                            adc=ADCConfig(bits=4), enc=fpca.WeightEncoding(n_levels=8))
    data = SyntheticVWW((20, 20))
    out = []
    for dev in (cuda, torch.device("cpu")):
        layer = FPCAFrontend(prog, model=model, device=dev)
        p0 = {"frontend": layer.init(torch.Generator().manual_seed(0)),
              "head": ex.init_head(torch.Generator().manual_seed(1), *layer.out_shape, device=dev)}
        before = fpca_conv_cuda.launches
        params, hist = ex.train("hw_aware", layer, data, 1, 4, params=p0)
        assert fpca_conv_cuda.launches == before
        out.append((params, hist[0]))
    (p_d, h_d), (p_h, h_h) = out
    assert abs(h_d["loss"] - h_h["loss"]) <= 1e-5
    assert abs(h_d["grad_norm"] - h_h["grad_norm"]) <= 1e-5 * max(1.0, h_h["grad_norm"])
    for a, b in zip(tree_leaves(p_d), tree_leaves(p_h)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_calibrate_gain_card_vs_host(cuda):
    spec = fpca.FPCASpec(image_h=60, image_w=60, out_channels=8, kernel=5, stride=5)
    for kw in ({}, {"enc": fpca.WeightEncoding(n_levels=8), "adc": ADCConfig(bits=4)}):
        gain, r2 = calibrate_gain(spec, device=cuda, **kw)
        want_gain, want_r2 = calibrate_gain(spec, device="cpu", **kw)
        assert gain == pytest.approx(want_gain, rel=1e-5)
        assert r2 == pytest.approx(want_r2, rel=1e-5)


# ---------------------------------------------------------------------------
# the LM serving path on the card
# ---------------------------------------------------------------------------


def test_zamba2_smoke_serving_launches_both_kernels_and_matches_the_host(cuda):
    cfg = reduce_for_smoke(ARCHS["zamba2-7b"])
    host = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = _to(host, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=torch.Generator().manual_seed(1))
    before = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)
    logits, cache = forward_prefill(card, cfg, tokens.to(cuda), max_len=208)
    assert (flash_attention_cuda.launches - before[0], ssd_intra_chunk_cuda.launches - before[1]) == (1, 3)
    want, want_cache = forward_prefill(host, cfg, tokens, max_len=208)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    nxt = logits.argmax(-1, keepdim=True)
    mid = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)
    l2, _ = forward_decode(card, cfg, nxt, cache, 200)
    assert (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches) == mid
    w2, _ = forward_decode(host, cfg, nxt.cpu(), want_cache, 200)
    torch.testing.assert_close(l2.cpu(), w2, rtol=1e-4, atol=1e-4)

    bf = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_model(bf, generator=torch.Generator(device=cuda).manual_seed(0))
    assert params["embed"]["table"].dtype == torch.bfloat16 and params["embed"]["table"].is_cuda
    lb, _ = forward_prefill(params, bf, tokens.to(cuda))
    assert bool(torch.isfinite(lb).all())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_dense_smoke_serving_launches_the_flash_kernel_and_matches_the_host(cuda, arch):
    """One flash launch per layer in prefill, none in decode; card logits
    within 1e-4 of the host's (f32); danube's 200-token prompt runs past its
    32-token smoke window, so prefill fills the ring buffer and decode
    overwrites it."""
    cfg = reduce_for_smoke(ARCHS[arch])
    host = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = _to(host, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=torch.Generator().manual_seed(1))
    before = flash_attention_cuda.launches
    logits, cache = forward_prefill(card, cfg, tokens.to(cuda), max_len=208)
    assert flash_attention_cuda.launches - before == cfg.n_layers
    want, want_cache = forward_prefill(host, cfg, tokens, max_len=208)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = want.argmax(-1, keepdim=True)
        mid = flash_attention_cuda.launches
        logits, cache = forward_decode(card, cfg, nxt.to(cuda), cache, 200 + step)
        assert flash_attention_cuda.launches == mid
        want, want_cache = forward_decode(host, cfg, nxt, want_cache, 200 + step)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def test_ssd_function_gradients_on_the_card_match_the_host(cuda):
    """SSDIntraChunk (the kernel forward, the closed-form backward) through
    ssd_chunked at a width whose chunks take the tensor-core design (q = 128,
    p = 64, n = 128, one group as a stride-0 view): outputs and gradients
    within 1e-4 of max|value| of the host's (the tensor-core forward's split
    products, f32 sums in another order); one launch, no plain version."""
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 1, 300, 4, 64, 128
    host = [torch.randn((b, l, h, p), generator=g), 0.3 * torch.rand((b, l, h), generator=g),
            -torch.rand(h, generator=g) - 0.5, torch.randn((b, l, 1, n), generator=g),
            torch.randn((b, l, 1, n), generator=g)]
    results = []
    for dev in ("cpu", cuda):
        ts = [t.to(dev).requires_grad_() for t in host]
        before = ssd_intra_chunk_cuda.launches
        y, s = ssd_ops.ssd_chunked(*ts, chunk=128)
        grads = torch.autograd.grad(y.square().sum() + s.sum(), ts)
        results.append([y.detach().cpu(), s.detach().cpu()] + [x.cpu() for x in grads])
        launched = ssd_intra_chunk_cuda.launches - before
    assert launched == 1
    for got, want in zip(results[1], results[0]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


_FAMILY_ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-2.7b", "internvl2-76b", "seamless-m4t-medium"]


def _frontend(cfg, b: int, n_src: int):
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.frontend_tokens if cfg.family == "vlm" else n_src
    return torch.randn((b, n, cfg.frontend_dim), generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("arch", _FAMILY_ARCHS)
def test_family_smoke_serving_on_the_card_matches_the_host(cuda, arch):
    """Prefill (encdec: 150 frames, a ragged key tile) and 3 decode steps of
    each remaining family on the narrow f32 config: card logits within 1e-4
    of the host's, the flash and SSD launches one per call, none in decode."""
    cfg = reduce_for_smoke(ARCHS[arch])
    host = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = _to(host, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=torch.Generator().manual_seed(1))
    fe = _frontend(cfg, 2, 150)
    off = cfg.frontend_tokens if cfg.family == "vlm" else 0
    before = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)
    logits, cache = forward_prefill(card, cfg, tokens.to(cuda), frontend_embeds=None if fe is None else fe.to(cuda),
                                    max_len=off + 208)
    flash = {"encdec": cfg.n_enc_layers + 2 * cfg.n_layers, "ssm": 0}.get(cfg.family, cfg.n_layers)
    assert (flash_attention_cuda.launches - before[0], ssd_intra_chunk_cuda.launches - before[1]) == (
        flash, cfg.n_layers if cfg.family == "ssm" else 0)
    want, want_cache = forward_prefill(host, cfg, tokens, frontend_embeds=fe, max_len=off + 208)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = want.argmax(-1, keepdim=True)
        mid = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)
        logits, cache = forward_decode(card, cfg, nxt.to(cuda), cache, off + 200 + step)
        assert (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches) == mid
        want, want_cache = forward_decode(host, cfg, nxt, want_cache, off + 200 + step)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", _FAMILY_ARCHS + ["zamba2-7b"])
def test_family_smoke_training_on_the_card_matches_the_host_under_every_remat(cuda, arch):
    """Loss and gradients of each family's narrow f32 config on the card
    within 1e-5 / 1e-4 of max|value| of the host's; on the card the
    gradients under full, dots and dots_no_batch equal those under none bit
    for bit, and each recomputing policy launches the flash forward twice a
    layer.  The tokens are distinct (a permutation of the vocabulary): the
    embedding's backward sums repeated tokens with atomic adds on the card,
    in an order that changes from run to run."""
    cfg = reduce_for_smoke(ARCHS[arch])
    host = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = _to(host, cuda)
    rng = torch.Generator().manual_seed(3)
    batch = {k: torch.randperm(cfg.vocab_size, generator=rng)[:192].reshape(2, 96) for k in ("tokens", "labels")}
    fe = _frontend(cfg, 2, 80)
    if fe is not None:
        batch["frontend"] = fe
    host_leaves = [t.requires_grad_() for t in tree_leaves(host)]
    card_leaves = [t.requires_grad_() for t in tree_leaves(card)]
    want_loss, _ = forward_train(host, cfg, batch, remat="none")
    want = torch.autograd.grad(want_loss, host_leaves)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    got = {}
    for remat in ("none", "full", "dots", "dots_no_batch"):
        before = flash_attention_cuda.launches
        loss, _ = forward_train(card, cfg, card_batch, remat=remat)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, card_leaves), flash_attention_cuda.launches - before)
    loss, grads, n_fwd = got["none"]
    assert abs(float(loss) - float(want_loss.detach())) <= 1e-5
    for x, w in zip(grads, want):
        assert float((x.cpu() - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    for remat in ("full", "dots", "dots_no_batch"):
        assert torch.equal(got[remat][0], loss), remat
        assert all(torch.equal(a, b) for a, b in zip(got[remat][1], grads)), remat
        assert got[remat][2] == 2 * n_fwd, remat
