from repro_torch.kernels.fpca_conv.kernel import (
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    precompute_weight_planes,
    weight_planes,
)
from repro_torch.kernels.fpca_conv.ops import (
    StickyBucket,
    fpca_conv,
    freeze_model,
    make_fpca_conv_executable,
    pad_to_lanes,
    thaw_model,
    window_bucket,
)
from repro_torch.kernels.fpca_conv.ref import fpca_conv_ref

__all__ = [
    "StickyBucket",
    "conv_tables",
    "fpca_conv",
    "fpca_conv_basis",
    "fpca_conv_cuda",
    "fpca_conv_ref",
    "freeze_model",
    "make_fpca_conv_executable",
    "pad_to_lanes",
    "precompute_weight_planes",
    "thaw_model",
    "weight_planes",
    "window_bucket",
]
