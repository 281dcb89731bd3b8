"""Flash-attention forward: the CUDA kernel's wrapper.

:func:`flash_attention_cuda` launches the hand-written kernel in
``csrc/flash_attention.cu`` on CUDA tensors; on CPU tensors it takes the
plain PyTorch version :func:`ref.flash_attention_ref`.  The kernel reads q,
k and v in the model's (B, S, heads, D) layout through their strides (the
head dim must be unit-stride) and writes a contiguous output in q's dtype
and, for training, the row log-sum-exp the backward kernels take.

The kernel has two designs in the one source, chosen by :func:`design`:
``"wgmma"`` (bf16 tensor cores, p split into bf16 hi + lo parts for p·V)
for bf16 inputs with ``D % 16 == 0`` and 16-byte-aligned rows, ``"simt"``
(f32 FMAs on CUDA cores) for everything else.  The choice is made before
the launch, never after a failure; a failed launch raises.  Beside
``.launches`` the wrapper counts its launches per design in ``.designs``.
The backward kernels (:mod:`.bwd`) choose by the same rule.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["design", "flash_attention_cuda", "MAX_HEAD_DIM", "DESIGNS"]

MAX_HEAD_DIM = 128
DESIGNS = ("wgmma", "simt")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _launcher() -> ctypes._CFuncPtr:
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_fwd_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B,Sq,H,D) and k, v (B,Sk,KV,D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if min(B, Sq, Sk, KV) < 1 or H % KV:
        raise ValueError(f"need non-empty inputs and H % KV == 0, got H={H}, KV={KV}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share one of float32/bfloat16/float16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit-stride head dim, got strides {t.stride()}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def design(*tensors: torch.Tensor) -> str:
    """The kernel design a launch on these inputs (q, k, v, and dO for the
    backward) takes: ``"wgmma"`` for bf16 with ``D % 16 == 0`` (D <= 128 is
    checked before) and every row of every input 16-byte aligned (the
    kernels stage rows by 16-byte copies), ``"simt"`` otherwise."""
    q = tensors[0]
    if q.dtype != torch.bfloat16 or q.shape[3] % 16:
        return "simt"
    aligned = all(t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]) for t in tensors)
    return "wgmma" if aligned else "simt"


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention forward ``(B,Sq,H,D)`` in q's dtype through the CUDA kernel.

    q ``(B,Sq,H,D)``, k/v ``(B,Sk,KV,D)``, one of float32/bfloat16/float16;
    query row i sees key j when j <= i (``causal``) and i - j < ``window``.
    With ``return_lse`` it returns ``(out, lse)``, lse ``(B,H,Sq)`` f32 (see
    :func:`repro_torch.models.attention.attend_blockwise`).  A CPU ``q``
    takes :func:`flash_attention_ref`; a CUDA one launches the kernel on the
    current stream, or raises.  Every launch adds one to
    ``flash_attention_cuda.launches`` and to its design's count in
    ``flash_attention_cuda.designs`` (:func:`design`).
    """
    if q.device.type in ("cpu", "meta"):   # meta: shapes only, no compute exists there
        return flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=return_lse)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    chosen = design(q, k, v)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KV, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), 0 if window is None else int(window), D**-0.5, int(chosen == "wgmma"),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel ({chosen}) launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.designs[chosen] += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.designs = dict.fromkeys(DESIGNS, 0)
