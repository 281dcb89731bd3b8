"""Plain PyTorch version of the SSD intra-chunk kernel."""

from __future__ import annotations

import torch

__all__ = ["ssd_intra_chunk_ref"]


def ssd_intra_chunk_ref(
    xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor, cum: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quadratic-within-chunk piece of SSD, in f32.

    xbar (b,nc,q,h,p) = x * dt; Bh/Ch (b,nc,q,h,n); cum (b,nc,q,h) = cumsum
    of ``dt * A`` within the chunk.  Returns (y_intra (b,nc,q,h,p), chunk
    states (b,nc,h,p,n), chunk decay (b,nc,h)).
    """
    q = xbar.shape[2]
    # L[i, j] = exp(cum_i - cum_j) for i >= j.  Mask the upper triangle
    # *before* the exp: its arguments are positive and overflow to inf.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (b,nc,i,j,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))[None, None, :, :, None]
    Lmask = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * Lmask, xbar)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (b,nc,q,h)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bh, decay_to_end, xbar)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (b,nc,h)
    return y_intra, states, chunk_decay
