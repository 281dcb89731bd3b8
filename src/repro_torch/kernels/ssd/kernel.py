"""Mamba2 SSD intra-chunk piece: the CUDA kernel's wrapper.

:func:`ssd_intra_chunk_cuda` launches the hand-written kernel in
``csrc/ssd_intra_chunk.cu`` on CUDA tensors; on CPU tensors it takes the
plain PyTorch version :func:`ref.ssd_intra_chunk_ref`.  Both keep the
contract of ``ssd_intra_chunk``: ``(y_intra, states (b,nc,h,p,n),
chunk_decay)``.

The kernel has two designs in the one source, chosen by :func:`design`:
``"wgmma"`` (bf16 tensor cores, every f32 operand split into three bf16
parts and each product run as six passes) for the served chunk (q = 128,
p = 64, n = 64 or 128) with 16-byte-aligned rows, ``"simt"`` (f32 FMAs on
CUDA cores) for every other shape.  The choice is made before the launch,
never after a failure; a failed launch raises.  Beside ``.launches`` the
wrapper counts its launches per design in ``.designs``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

__all__ = ["design", "ssd_intra_chunk_cuda", "MAX_CHUNK", "MAX_DIM", "DESIGNS"]

MAX_CHUNK = 128   # chunk positions per block
MAX_DIM = 128     # head channels P and state channels N
DESIGNS = ("wgmma", "simt")


@functools.cache
def _launcher() -> ctypes._CFuncPtr:
    from repro_torch.kernels import _build

    fn = _build.load("ssd_intra_chunk").ssd_intra_chunk_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor, cum: torch.Tensor) -> None:
    if xbar.dim() != 5 or Bh.dim() != 5 or Ch.shape != Bh.shape:
        raise ValueError(
            f"expected xbar (b,nc,q,h,p) and Bh, Ch (b,nc,q,h,n), got {tuple(xbar.shape)}, "
            f"{tuple(Bh.shape)}, {tuple(Ch.shape)}"
        )
    b, nc, q, h, p = xbar.shape
    n = Bh.shape[-1]
    if tuple(Bh.shape[:4]) != (b, nc, q, h) or tuple(cum.shape) != (b, nc, q, h):
        raise ValueError(
            f"Bh {tuple(Bh.shape)} / cum {tuple(cum.shape)} do not match xbar {tuple(xbar.shape)}"
        )
    if min(b, nc, h) < 1 or not 1 <= q <= MAX_CHUNK or not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"need q <= {MAX_CHUNK} and p, n <= {MAX_DIM}, got q={q}, p={p}, n={n}")
    for name, t in (("xbar", xbar), ("Bh", Bh), ("Ch", Ch), ("cum", cum)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != xbar.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on xbar's CUDA device, got {t.device}")
    if not (xbar.is_contiguous() and cum.is_contiguous()):
        raise ValueError("xbar and cum must be contiguous")
    for name, t in (("Bh", Bh), ("Ch", Ch)):
        if t.stride(4) != 1:
            raise ValueError(f"{name} needs a unit-stride state dim, got strides {t.stride()}")


def design(xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor) -> str:
    """The kernel design a launch on these inputs takes: ``"wgmma"`` for a
    chunk of q = 128 with p = 64 and n = 64 or 128, xbar, Bh and Ch
    16-byte aligned, every Bh/Ch stride a multiple of 4 elements (the
    kernel stages their rows by 16-byte loads; a stride of 0 is one) and
    b·nc <= 65535 (a grid dimension); ``"simt"`` otherwise."""
    b, nc, q, _, p = xbar.shape
    n = Bh.shape[-1]
    if q != MAX_CHUNK or p != 64 or n not in (64, 128) or b * nc > 65535:
        return "simt"
    aligned = all(t.data_ptr() % 16 == 0 for t in (xbar, Bh, Ch)) and all(
        st % 4 == 0 for t in (Bh, Ch) for st in t.stride()[:4])
    return "wgmma" if aligned else "simt"


def ssd_intra_chunk_cuda(
    xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor, cum: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD through the CUDA kernel.

    xbar ``(b,nc,q,h,p)`` and cum ``(b,nc,q,h)`` contiguous float32; Bh/Ch
    ``(b,nc,q,h,n)`` float32 with any strides whose state dim is unit-stride
    (a head stride of 0 broadcasts one group over the heads without a
    copy).  Returns ``(y_intra (b,nc,q,h,p), states (b,nc,h,p,n),
    chunk_decay (b,nc,h))``.  A CPU ``xbar`` takes
    :func:`ssd_intra_chunk_ref`; a CUDA one launches the kernel on the
    current stream, or raises (also when grad mode is on and an input
    requires grad: the gradient is :class:`~repro_torch.kernels.ssd.bwd.SSDIntraChunk`'s).  Every launch adds one to
    ``ssd_intra_chunk_cuda.launches`` and to its design's count in
    ``ssd_intra_chunk_cuda.designs`` (:func:`design`).
    """
    if xbar.device.type == "cpu":
        return ssd_intra_chunk_ref(xbar, Bh, Ch, cum)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xbar, Bh, Ch, cum)):
        # the kernel's outputs would carry no grad_fn and drop these gradients
        raise RuntimeError(
            "ssd_intra_chunk_cuda has no backward of its own: under autograd call "
            "SSDIntraChunk.apply (kernels/ssd/bwd.py: this kernel's forward and a closed-form "
            "backward), or call it under torch.no_grad()"
        )
    _check(xbar, Bh, Ch, cum)
    b, nc, q, h, p = xbar.shape
    n = Bh.shape[-1]
    y = torch.empty_like(xbar)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xbar.device)
    chosen = design(xbar, Bh, Ch)
    with torch.cuda.device(xbar.device):
        err = _launcher()(
            xbar.data_ptr(), Bh.data_ptr(), Ch.data_ptr(), cum.data_ptr(),
            y.data_ptr(), states.data_ptr(), b, nc, q, h, p, n,
            *Bh.stride()[:4], *Ch.stride()[:4], int(chosen == "wgmma"),
            torch.cuda.current_stream(xbar.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ssd_intra_chunk kernel ({chosen}) launch failed with CUDA error {err}")
    ssd_intra_chunk_cuda.launches += 1
    ssd_intra_chunk_cuda.designs[chosen] += 1
    return y, states, torch.exp(cum[:, :, -1, :])


ssd_intra_chunk_cuda.launches = 0
ssd_intra_chunk_cuda.designs = dict.fromkeys(DESIGNS, 0)
