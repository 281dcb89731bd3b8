"""The paper-representative cell, the port of ``repro.launch.fpca_cell``:
the FPCA frontend at production scale.

Workload: a video/sensor-fleet frontend — ``batch`` frames of
``sensor x sensor`` RGB through the 5x5x3, 8-channel, stride-5 FPCA
convolution.  Each rank takes its ``global_batch / data_extent`` frames
(with ``row_shard``, row groups folded into the batch first, so the
``model`` axis splits the windows too; a batch that does not divide splits
as DTensor splits it, the leading ranks taking one more); the convolution is embarrassingly
parallel over windows, so the step has no collective.

The step runs :func:`~repro_torch.core.fpca_sim.encode_weights`, then
:func:`~repro_torch.core.fpca_sim.extract_windows` on bf16 frames (the f32
cast happens at the patch matrix), then the fpca op:

* on the card, the fpca_conv kernel through
  :func:`~repro_torch.kernels.fpca_conv.kernel.fpca_conv_cuda` (one launch
  over every window of the rank's frames);
* on the host and on ``meta``, the plain basis version with the
  reference's levers: ``fuse_phases`` (both weight phases in one matmul
  bank) and ``compute_dtype`` (the products' operands rounded to it, the
  sums in f32, as ``fpca_conv_basis_jnp`` does).  Unlike the reference's
  XLA lowering it does not pad the 75 pixel slots to 128 lanes: the port's
  kernel reads them unpadded.

A lever the kernel does not implement raises on the card rather than
running the plain version: ``compute_dtype=torch.bfloat16`` (the kernel
takes f32 patches).  ``fuse_phases`` is what the kernel does anyway, both
phases from one read of each tile.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.fpca_sim import WeightEncoding, encode_weights, extract_windows
from repro_torch.core.mapping import FPCASpec, output_dims
from repro_torch.kernels.fpca_conv.kernel import (
    _MM_PAIRS,
    basis_epilogue,
    conv_tables,
    fpca_conv_cuda,
    precompute_weight_planes,
    weight_planes,
)
from repro_torch.launch.mesh import axis_sizes

__all__ = ["FpcaShape", "FPCA_SHAPES", "SPEC_TEMPLATE", "FpcaCellInfo", "build_fpca_cell", "fpca_basis_levers"]


@dataclasses.dataclass(frozen=True)
class FpcaShape:
    name: str
    sensor: int
    global_batch: int
    kind: str = "frontend"


# sensor sizes are multiples of stride x |model axis| (5 x 16 = 80), so the
# image height splits over 'model' with window extraction fully local
FPCA_SHAPES = {
    "video_1080": FpcaShape("video_1080", 1120, 256),   # HD-class
    "sensor_4k": FpcaShape("sensor_4k", 2240, 32),      # 4K-class
}

SPEC_TEMPLATE = dict(out_channels=8, kernel=5, stride=5, max_kernel=5)


@dataclasses.dataclass(frozen=True)
class FpcaCellInfo:
    """Just enough of the ModelConfig protocol for roofline accounting."""

    name: str
    spec: FPCASpec
    batch: int

    def active_param_count(self) -> int:
        s = self.spec
        return s.out_channels * s.kernel * s.kernel * s.in_channels

    @property
    def windows(self) -> int:
        h_o, w_o = output_dims(self.spec)
        return h_o * w_o

    def model_flops(self) -> float:
        """Useful work: the ideal convolution, both weight phases."""
        n = self.spec.n_active_pixels
        return 2.0 * self.batch * self.windows * n * self.spec.out_channels * 2


def fpca_basis_levers(
    patches: torch.Tensor, w_pos: torch.Tensor, w_neg: torch.Tensor, tables, bn_offset: torch.Tensor,
    *, fuse_phases: bool = False, compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The plain basis version with the reference's levers: counts ``(M, C)``
    from ``patches (M, N)`` and the phases' conductances ``w_pos``,
    ``w_neg`` ``(N, C)``.  Products take their operands in
    ``compute_dtype`` (default f32) and sum in f32."""
    cdt = compute_dtype or torch.float32
    x = patches.to(cdt)
    xp = {1: x, 2: x * x, 3: x * x * x}

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dtype == torch.float32:
            return a @ b.float()
        if a.device.type == "meta":     # shapes only: count the cdt operands
            return torch.mm(a, b.to(a.dtype), out_dtype=torch.float32)
        return a.float() @ b.to(a.dtype).float()   # cdt products are exact in f32

    rv = {a: dot(xp[a], tables.mask[:, None]) for a in (1, 2, 3)}

    def planes_of(w: torch.Tensor) -> dict:
        return precompute_weight_planes(w.float(), tables.mask, tables.model)

    if fuse_phases:
        C = w_pos.shape[1]
        both = planes_of(torch.cat([w_pos, w_neg], dim=1))
        mm = {(a, b): dot(xp[a], both["w_pows"][b - 1]) for (a, b) in _MM_PAIRS}
        planes = {k: torch.stack([v[..., :C], v[..., C:]]) for k, v in both.items()}
        mms = [{k: v[:, :C] for k, v in mm.items()}, {k: v[:, C:] for k, v in mm.items()}]
    else:
        pp, pn = planes_of(w_pos), planes_of(w_neg)
        planes = {k: torch.stack([pp[k], pn[k]]) for k in pp}
        mms = [{(a, b): dot(xp[a], p["w_pows"][b - 1]) for (a, b) in _MM_PAIRS} for p in (pp, pn)]
    return basis_epilogue(rv, mms, planes, tables, bn_offset)


def _local_frames(mesh, total: int, row_shard: bool) -> int:
    """This rank's frames of ``total`` split over the data axes (and
    ``model`` with ``row_shard``) as DTensor splits a dim: chunks of
    ceil(total / ranks) in rank order, so a batch smaller than the rank
    count leaves the last ranks none."""
    axes = [a for a in mesh.mesh_dim_names if a in ("pod", "data") or (row_shard and a == "model")]
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate() or [0] * mesh.ndim))
    idx, lead = 0, 1
    for a in axes:
        idx, lead = idx * sizes[a] + coord[a], lead * sizes[a]
    chunk = -(-total // lead)
    return max(0, min(chunk, total - idx * chunk))


def build_fpca_cell(
    shape: FpcaShape, mesh, model, *,
    fuse_phases: bool = False, compute_dtype: torch.dtype | None = None, row_shard: bool = False,
    device: str | torch.device | None = None, seed: int = 0,
) -> tuple[Any, tuple, FpcaCellInfo]:
    """Returns (step, args, info) for this rank.  ``model`` is a fitted
    :class:`~repro_torch.core.curvefit.BucketCurvefitModel`.

    ``device`` defaults to the mesh's (the current card under NCCL); on
    ``meta`` the args are empty, elsewhere the frames are uniform in [0, 1)
    and the kernel normal, both drawn from ``seed``.  ``fuse_phases`` /
    ``compute_dtype`` / ``row_shard`` are the reference's levers."""
    spec = FPCASpec(image_h=shape.sensor, image_w=shape.sensor, **SPEC_TEMPLATE)
    info = FpcaCellInfo(name="fpca-frontend", spec=spec, batch=shape.global_batch)
    adc = ADCConfig()
    enc = WeightEncoding()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and compute_dtype not in (None, torch.float32):
        raise ValueError(
            f"compute_dtype={compute_dtype}: the fpca kernel takes f32 patches; "
            "this lever runs only as the plain version on the host or on meta"
        )

    # row_shard: fold row-groups into the batch at the input layout —
    # (B, H, W, C) -> (B * m, H/m, W, C), the leading dim over the data axes
    # and 'model'; window extraction stays local (stride == window: no halo)
    m_size = axis_sizes(mesh).get("model", 1) if row_shard else 1
    if (shape.sensor // SPEC_TEMPLATE["stride"]) % m_size:
        raise ValueError("sensor rows must divide the model axis for row_shard")
    group_h = shape.sensor // m_size
    group_spec = FPCASpec(image_h=group_h, image_w=shape.sensor, **SPEC_TEMPLATE)
    local_b = _local_frames(mesh, shape.global_batch * m_size, row_shard)
    tables = conv_tables(model, adc, spec.n_active_pixels, dev)
    C = spec.out_channels

    def step(images: torch.Tensor, kernel: torch.Tensor, bn_offset: torch.Tensor) -> torch.Tensor:
        w_pos, w_neg = encode_weights(kernel, group_spec, enc)
        patches = extract_windows(images, group_spec)      # f32, from the bf16 frames
        Bg, h_o, w_o, N = patches.shape
        flat = patches.reshape(Bg * h_o * w_o, N)
        if flat.device.type == "cuda":
            counts = fpca_conv_cuda(flat, weight_planes(w_pos.T, w_neg.T, tables), tables, bn_offset)
        else:
            counts = fpca_basis_levers(flat, w_pos.T, w_neg.T, tables, bn_offset,
                                       fuse_phases=fuse_phases, compute_dtype=compute_dtype)
        return counts.reshape(Bg, h_o, w_o, C)

    img_shape = (local_b, group_h, shape.sensor, spec.in_channels)
    k = spec.kernel
    kern_shape = (C, k, k, spec.in_channels)
    if dev.type == "meta":
        args = (torch.empty(img_shape, dtype=torch.bfloat16, device=dev),
                torch.empty(kern_shape, device=dev), torch.empty((C,), device=dev))
    else:
        g = torch.Generator(dev).manual_seed(seed)
        images = torch.rand(img_shape, generator=g, device=dev).to(torch.bfloat16)
        kernel = torch.randn(kern_shape, generator=g, device=dev) * 0.3
        args = (images, kernel, torch.zeros((C,), device=dev))
    return step, args, info
