"""On-card checks of the port's CUDA kernel; each skips on a host without a
CUDA device.  The tests import only the port, so they run on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: the kernel against its plain PyTorch version, at most 1 ADC
count and fewer than 5% of counts off (sums in another order can cross a
round-half boundary); padding rows of a region-skip bucket are exact zeros.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch import fpca
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.kernels.fpca_conv.kernel import (
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    weight_planes,
)

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


@pytest.mark.parametrize("m,n,c", [(1, 75, 1), (127, 75, 8), (129, 75, 13), (5000, 75, 16),
                                   (300, 27, 8), (300, 48, 5)])
@pytest.mark.parametrize("bits", [8, 16])
def test_kernel_matches_plain_version(cuda, model, m, n, c, bits):
    """Ragged rows and channel tiles, odd and even pixel counts."""
    patches, w_pos, w_neg, bn = _inputs(m, n, c, cuda, seed=m + n + c)
    tables = conv_tables(model, ADCConfig(bits=bits), n, cuda)
    planes = weight_planes(w_pos, w_neg, tables)
    before = fpca_conv_cuda.launches
    got = fpca_conv_cuda(patches, planes, tables, bn)
    want = fpca_conv_basis(patches, planes, tables, bn)
    torch.cuda.synchronize()
    assert fpca_conv_cuda.launches == before + 1
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.05
    valid = (torch.arange(m, device=cuda) % 4 != 1).float()
    got_v = fpca_conv_cuda(patches, planes, tables, bn, row_valid=valid)
    assert bool((got_v[valid == 0] == 0).all())
    assert torch.equal(got_v[valid == 1], got[valid == 1])


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
    before = fpca_conv_cuda.launches
    counts = m.run_frontend_weighted(m.kernel, m.bn_offset, frames)
    block = torch.zeros((6, 6), dtype=torch.bool)
    block[2:4, 1:5] = True
    logits = m.run(frames, block_mask=block)
    assert fpca_conv_cuda.launches == before + 2
    want = b.run_frontend_weighted(b.kernel, b.bn_offset, frames)
    diff = (counts - want).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 0.05
    assert logits.shape == (5, 3) and bool(torch.isfinite(logits).all())
