"""The production FPCA cell (``repro_torch.launch.fpca_cell``) against the
reference's (``repro.launch.fpca_cell``) on a small shape, on the host.

Tolerances: counts within the fpca limit (at most 1 ADC count off on fewer
than 5% of counts: f32 sums in another order flip round-half points; the
port's plain version also reads 75 pixel slots where the reference pads to
128 zero lanes), with and without ``fuse_phases`` and bf16 operands;
``FpcaCellInfo`` equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_checks import counts_close
from repro.launch import fpca_cell as j_cell
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch.convert import bucket_model_from_dict
from repro_torch.launch import fpca_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.step_analysis import analyze_step

SMALL = dict(name="small", sensor=80, global_batch=2)


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    kernel = (rng.normal(size=(8, 5, 5, 3)) * 0.3).astype(np.float32)
    bn = rng.integers(0, 24, 8).astype(np.float32)
    return images, kernel, bn


def test_shapes_template_and_info_match_reference():
    assert {k: vars(v) for k, v in fpca_cell.FPCA_SHAPES.items()} == {k: vars(v) for k, v in j_cell.FPCA_SHAPES.items()}
    assert fpca_cell.SPEC_TEMPLATE == j_cell.SPEC_TEMPLATE
    for name in fpca_cell.FPCA_SHAPES:
        s = fpca_cell.FPCA_SHAPES[name]
        spec = fpca_cell.FPCASpec(image_h=s.sensor, image_w=s.sensor, **fpca_cell.SPEC_TEMPLATE)
        j_spec = j_cell.FPCASpec(image_h=s.sensor, image_w=s.sensor, **j_cell.SPEC_TEMPLATE)
        got = fpca_cell.FpcaCellInfo("fpca-frontend", spec, s.global_batch)
        want = j_cell.FpcaCellInfo("fpca-frontend", j_spec, s.global_batch)
        assert (got.active_param_count(), got.windows, got.model_flops()) == (
            want.active_param_count(), want.windows, want.model_flops())
    # video_1080: 256 x 224^2 windows through one launch
    assert fpca_cell.FPCA_SHAPES["video_1080"].global_batch * 224 * 224 == 12_845_056


@pytest.mark.parametrize("fuse,bf16", [(False, False), (True, False), (False, True), (True, True)])
def test_cell_counts_match_reference(bucket_model, port_model, mesh, fuse, bf16):
    images, kernel, bn = _inputs()
    j_step, _, j_info = j_cell.build_fpca_cell(
        j_cell.FpcaShape(**SMALL), j_host_mesh(1, 1), bucket_model,
        fuse_phases=fuse, compute_dtype=jnp.bfloat16 if bf16 else None)
    want = np.asarray(j_step(jnp.asarray(images, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bn)))
    step, args, info = fpca_cell.build_fpca_cell(
        fpca_cell.FpcaShape(**SMALL), mesh, port_model, fuse_phases=fuse,
        compute_dtype=torch.bfloat16 if bf16 else None, device="cpu")
    assert tuple(args[0].shape) == (2, 80, 80, 3) and args[0].dtype == torch.bfloat16
    got = step(torch.tensor(images).to(torch.bfloat16), torch.tensor(kernel), torch.tensor(bn)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 8)
    counts_close(got, want)
    assert (info.windows, info.model_flops()) == (j_info.windows, j_info.model_flops())


def test_fused_phases_equal_unfused_in_the_port(port_model, mesh):
    images, kernel, bn = _inputs(1)
    args = (torch.tensor(images).to(torch.bfloat16), torch.tensor(kernel), torch.tensor(bn))
    a = fpca_cell.build_fpca_cell(fpca_cell.FpcaShape(**SMALL), mesh, port_model, device="cpu")[0](*args)
    b = fpca_cell.build_fpca_cell(fpca_cell.FpcaShape(**SMALL), mesh, port_model, fuse_phases=True,
                                  device="cpu")[0](*args)
    counts_close(a.numpy(), b.numpy())


def test_cell_on_meta_counts_and_row_shard(port_model, mesh):
    """On meta nothing is computed; the counter sees the plain version's
    products, and the fused bank reads the patches once, not twice."""
    shape = fpca_cell.FpcaShape(**SMALL)
    step, args, info = fpca_cell.build_fpca_cell(shape, mesh, port_model, device="meta")
    assert all(a.device.type == "meta" for a in args)
    plain = analyze_step(step, *args)
    fused = analyze_step(fpca_cell.build_fpca_cell(shape, mesh, port_model, fuse_phases=True, device="meta")[0], *args)
    M, N, C = 2 * 16 * 16, 75, 8
    assert plain.flops == fused.flops > 2 * 3 * 2 * M * N * C
    assert fused.bytes_proxy < plain.bytes_proxy
    _, rs_args, _ = fpca_cell.build_fpca_cell(shape, mesh, port_model, row_shard=True, device="meta")
    assert tuple(rs_args[0].shape) == (2, 80, 80, 3)    # model extent 1: nothing folds


def test_bf16_operands_on_the_card_raise(port_model, mesh):
    """The fpca kernel takes f32 patches: a bf16 lever on the card raises
    instead of running the plain version (checked before anything touches
    the card)."""
    with pytest.raises(ValueError, match="takes f32 patches"):
        fpca_cell.build_fpca_cell(fpca_cell.FpcaShape(**SMALL), mesh, port_model,
                                  compute_dtype=torch.bfloat16, device="cuda")


def test_extract_windows_casts_at_the_patch_matrix():
    """Windows from bf16 frames equal windows from the same frames in f32,
    and come out f32."""
    from repro_torch.core.fpca_sim import extract_windows
    from repro_torch.core.mapping import FPCASpec

    spec = FPCASpec(image_h=40, image_w=40, **fpca_cell.SPEC_TEMPLATE)
    x = torch.rand((3, 40, 40, 3)).to(torch.bfloat16)
    a, b = extract_windows(x, spec), extract_windows(x.float(), spec)
    assert a.dtype == torch.float32 and torch.equal(a, b)
