"""Small-CNN building blocks: the digital head behind an FPCA frontend.

Plain functions on tensors, parameters in dicts.  Layouts are the
reference's: NHWC activations, ``(c_out, k, k, c_in)`` conv kernels and
``(d_in, d_out)`` dense weights.  Everything is float32; convolutions run
with TF32 off, so "f32" means IEEE f32 on the card as on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

__all__ = ["init_conv2d", "conv2d", "init_linear", "linear", "max_pool2d", "avg_pool2d"]


def init_conv2d(
    c_in: int,
    c_out: int,
    kernel: int,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Biased conv params: ``w`` is ``(c_out, k, k, c_in)``.  ``generator``
    is a CPU generator; the draws are moved to ``device`` (the card by
    default)."""
    fan_in = kernel * kernel * c_in
    w = torch.randn((c_out, kernel, kernel, c_in), generator=generator) * fan_in**-0.5
    dev = resolve_device(device)
    return {"w": w.to(dev), "b": torch.zeros(c_out, device=dev)}


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding: output ceil(size / stride), extra pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params: dict, x: torch.Tensor, stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """NHWC convolution with bias; ``padding`` is ``"VALID"`` or ``"SAME"``."""
    w = params["w"]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        k = w.shape[1]
        (ht, hb), (wl, wr) = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
        xc = F.pad(xc, (wl, wr, ht, hb))
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        out = F.conv2d(xc, w.permute(0, 3, 1, 2), stride=stride)
    return out.permute(0, 2, 3, 1) + params["b"]


def init_linear(
    d_in: int,
    d_out: int,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Biased dense params: ``w`` is ``(d_in, d_out)``."""
    w = torch.randn((d_in, d_out), generator=generator) * d_in**-0.5
    dev = resolve_device(device)
    return {"w": w.to(dev), "b": torch.zeros(d_out, device=dev)}


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def max_pool2d(x: torch.Tensor, size: int, stride: int | None = None) -> torch.Tensor:
    s = size if stride is None else stride
    return F.max_pool2d(x.permute(0, 3, 1, 2), size, s).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, size: int, stride: int | None = None) -> torch.Tensor:
    s = size if stride is None else stride
    return F.avg_pool2d(x.permute(0, 3, 1, 2), size, s).permute(0, 2, 3, 1)
