"""Flash-attention backward: the wrappers of the CUDA dQ and dK/dV kernels.

:func:`flash_attention_bwd_cuda` forms ``delta = rowsum(dO * O)`` in f32
(a torch op, as the reference forms it outside Pallas) and launches the two
hand-written kernels of ``csrc/flash_attention_bwd.cu``,
:func:`flash_attention_dq_cuda` and :func:`flash_attention_dkdv_cuda`.  On
CPU tensors each takes the plain version :func:`bwd_ref.flash_attention_bwd_ref`.
The kernels read q, k, v and dO through their strides (the head dim must be
unit-stride) and write contiguous gradients in the inputs' dtype.

Each kernel has two designs in the one source, chosen by
:func:`~repro_torch.kernels.flash_attention.kernel.design`, as the forward's:
``"wgmma"`` (bf16 tensor cores, p and ds split into bf16 hi + lo parts) for
bf16 inputs with ``D % 16 == 0`` and 16-byte-aligned rows, ``"simt"`` (f32
FMAs on CUDA cores) for everything else.  The choice is made before the
launch, never after a failure; a failed launch raises.  Beside ``.launches``
each wrapper counts its launches per design in ``.designs``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.bwd_ref import attention_delta, flash_attention_bwd_ref
from repro_torch.kernels.flash_attention.kernel import _DTYPES, DESIGNS, _check, design

__all__ = ["design", "flash_attention_bwd_cuda", "flash_attention_dq_cuda", "flash_attention_dkdv_cuda"]


@functools.cache
def _launchers() -> tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]:
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_bwd")
    tail = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p]
    dq, dkdv = lib.flash_attention_bwd_dq_launch, lib.flash_attention_bwd_dkdv_launch
    dq.argtypes = [ctypes.c_void_p] * 7 + tail
    dkdv.argtypes = [ctypes.c_void_p] * 8 + tail
    dq.restype = dkdv.restype = ctypes.c_int
    return dq, dkdv


def _check_bwd(q, k, v, do, lse, delta, window) -> None:
    _check(q, k, v, window)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(3) != 1:
        raise ValueError(
            f"dO must match q {tuple(q.shape)} {q.dtype} with a unit-stride head dim, got "
            f"{tuple(do.shape)} {do.dtype} strides {do.stride()}"
        )
    B, Sq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 {(B, H, Sq)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _args(q, k, v, do, lse, delta, causal, window):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    chosen = design(q, k, v, do)
    tail = (_DTYPES[q.dtype], B, Sq, Sk, H, KV, D, strides, int(causal),
            0 if window is None else int(window), D**-0.5, int(chosen == "wgmma"),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail, chosen


def flash_attention_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, *, causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """dQ ``(B,Sq,H,D)`` in q's dtype through the CUDA kernel, from q/dO
    ``(B,Sq,H,D)``, k/v ``(B,Sk,KV,D)`` and the f32 ``(B,H,Sq)`` lse and
    delta.  A CPU ``q`` takes the plain version; a CUDA one launches the
    kernel on the current stream, or raises.  Every launch adds one to
    ``flash_attention_dq_cuda.launches`` and to its design's count in
    ``flash_attention_dq_cuda.designs``."""
    if q.device.type in ("cpu", "meta"):   # meta: shapes only, no compute exists there
        return _plain(q, k, v, do, lse, delta, causal, window)[0]
    _check_bwd(q, k, v, do, lse, delta, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    head, tail, chosen = _args(q, k, v, do, lse, delta, causal, window)
    with torch.cuda.device(q.device):
        err = _launchers()[0](*head, dq.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"flash_attention_bwd dq kernel ({chosen}) launch failed with CUDA error {err}")
    flash_attention_dq_cuda.launches += 1
    flash_attention_dq_cuda.designs[chosen] += 1
    return dq


def flash_attention_dkdv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, *, causal: bool = True, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) ``(B,Sk,KV,D)`` in k's dtype through the CUDA kernel, the G
    query heads of each kv head summed in f32 (arguments as
    :func:`flash_attention_dq_cuda`).  Every launch adds one to
    ``flash_attention_dkdv_cuda.launches`` and to its design's count in
    ``flash_attention_dkdv_cuda.designs``."""
    if q.device.type in ("cpu", "meta"):   # meta: shapes only, no compute exists there
        return _plain(q, k, v, do, lse, delta, causal, window)[1:]
    _check_bwd(q, k, v, do, lse, delta, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    head, tail, chosen = _args(q, k, v, do, lse, delta, causal, window)
    with torch.cuda.device(q.device):
        err = _launchers()[1](*head, dk.data_ptr(), dv.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"flash_attention_bwd dkdv kernel ({chosen}) launch failed with CUDA error {err}")
    flash_attention_dkdv_cuda.launches += 1
    flash_attention_dkdv_cuda.designs[chosen] += 1
    return dk, dv


for _fn in (flash_attention_dq_cuda, flash_attention_dkdv_cuda):
    _fn.launches = 0
    _fn.designs = dict.fromkeys(DESIGNS, 0)
del _fn


def _plain(q, k, v, do, lse, delta, causal, window):
    return flash_attention_bwd_ref(q, k, v, None, lse, do, causal=causal, window=window, delta=delta)


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention through the two CUDA kernels; layouts of
    ``flash_attention_bwd_pallas``: q/out/do ``(B,Sq,H,D)``, k/v
    ``(B,Sk,KV,D)``, lse ``(B,H,Sq)`` f32 (the forward kernel's).  A dO
    whose head dim is not unit-stride is made contiguous first.  A CPU
    ``q`` takes :func:`flash_attention_bwd_ref`."""
    if q.device.type in ("cpu", "meta"):   # meta: shapes only, no compute exists there
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    if do.stride(3) != 1:
        do = do.contiguous()
    delta = attention_delta(out, do)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_attention_dkdv_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv
