"""Full chunked SSD: the intra-chunk kernel plus the inter-chunk recurrence
(a loop of torch ops over chunks).  Same contract as
:func:`repro_torch.models.ssm.ssd_chunked`, which runs this body with the
plain intra-chunk version."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

__all__ = ["ssd_chunked"]


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: torch.Tensor | None = None,
    intra_chunk: Callable = ssd_intra_chunk_cuda,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (b,l,h,p), dt (b,l,h), A (h,), B/C (b,l,g,n).
    Returns (y (b,l,h,p) in x's dtype, final_state (b,h,p,n) f32).

    ``intra_chunk`` defaults to the kernel's wrapper (CUDA kernel on the
    card, plain version on the host).  One state group is broadcast over
    the heads as a stride-0 view, never copied; several groups are
    repeated, as the reference does."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = B.reshape(b, nc, q, g, n).float()
    Cc = C.reshape(b, nc, q, g, n).float()
    if g == 1:
        Bh = Bc.expand(b, nc, q, h, n)
        Ch = Cc.expand(b, nc, q, h, n)
    else:
        Bh = Bc.repeat_interleave(h // g, dim=3)
        Ch = Cc.repeat_interleave(h // g, dim=3)

    logd = dtc * A.float()                                       # (b, nc, q, h), <= 0
    cum = torch.cumsum(logd, dim=2)
    xbar = xc * dtc[..., None]
    y_intra, states, chunk_decay = intra_chunk(xbar, Bh, Ch, cum)

    s = (initial_state.float() if initial_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):                                          # state *before* each chunk
        prev.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (b,nc,h,p,n)
    y_inter = torch.einsum("bcihn,bchpn,bcih->bcihp", Ch, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :l]
    return y.to(x.dtype), s
