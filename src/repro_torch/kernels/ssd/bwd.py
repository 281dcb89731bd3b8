"""The SSD intra-chunk piece under autograd: the CUDA kernel forward, a
closed-form backward in torch einsums.

The reference has no Pallas backward for SSD: it differentiates its jnp
``ssd_chunked``.  :class:`SSDIntraChunk` runs the forward through
:func:`~repro_torch.kernels.ssd.kernel.ssd_intra_chunk_cuda` (the kernel on
the card, the plain version on the host), saves ``(xbar, Bh, Ch, cum)``
and computes the gradient from them, never by re-running the plain
version under autograd.  Per (batch, chunk, head), with L = exp(segsum(cum))
lower-triangular, cb = C Bᵀ, M = cb ∘ L and w_j = exp(cum_end - cum_j):

    y = M xbar,  states = (B ∘ w)ᵀ xbar,  chunk_decay = exp(cum_end)

so, from dy, dS = d(states) and d(chunk_decay):

    dM     = dy xbarᵀ (its upper triangle is masked by L)
    d(cb)  = dM ∘ L,        dL ∘ L = dM ∘ cb ∘ L =: Γ
    dC     = d(cb) B,       dB = d(cb)ᵀ C + w ∘ (xbar dS)
    dxbar  = Mᵀ dy + w ∘ (B dSᵀ)
    dw_j   = Σ B ∘ (xbar dS),  with dcum_j -= dw_j w_j and dcum_end += Σ_j dw_j w_j
    dcum   = rowsum(Γ) - colsum(Γ) + the w terms + d(chunk_decay) chunk_decay at cum_end

A head stride of 0 (one state group broadcast over the heads, an
``expand`` view) gets a full-shape gradient; ``expand``'s backward sums it
over the heads.  :func:`ssd_intra_chunk` takes the Function when a
gradient is needed and the bare kernel otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

__all__ = ["SSDIntraChunk", "ssd_intra_chunk", "ssd_intra_chunk_bwd"]


def ssd_intra_chunk_bwd(
    xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor, cum: torch.Tensor,
    dy: torch.Tensor, dstates: torch.Tensor, ddecay: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dxbar, dBh, dCh, dcum) of ``ssd_intra_chunk`` in f32, shapes as its
    inputs: xbar (b,nc,q,h,p), Bh/Ch (b,nc,q,h,n), cum (b,nc,q,h); dy as
    y, dstates (b,nc,h,p,n), ddecay (b,nc,h)."""
    q = xbar.shape[2]
    cum_h = cum.transpose(2, 3)                                          # (b,nc,h,q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]                      # (b,nc,h,i,j)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))
    L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    del seg
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    dcb = torch.einsum("bcihp,bcjhp->bchij", dy, xbar) * L               # dM ∘ L
    gamma = dcb * cb                                                     # dL ∘ L
    dxbar = torch.einsum("bchij,bcihp->bcjhp", cb * L, dy)
    del cb, L
    dC = torch.einsum("bchij,bcjhn->bcihn", dcb, Bh)
    dB = torch.einsum("bchij,bcihn->bcjhn", dcb, Ch)
    del dcb
    w = torch.exp(cum[:, :, -1:, :] - cum)                               # (b,nc,q,h)
    xs = torch.einsum("bcjhp,bchpn->bcjhn", xbar, dstates)
    dB = dB + w[..., None] * xs
    dxbar = dxbar + w[..., None] * torch.einsum("bcjhn,bchpn->bcjhp", Bh, dstates)
    dww = (Bh * xs).sum(dim=-1) * w                                      # dw_j w_j
    dcum = (gamma.sum(dim=-1) - gamma.sum(dim=-2)).transpose(2, 3) - dww
    dcum[:, :, -1, :] += dww.sum(dim=2) + ddecay * torch.exp(cum[:, :, -1, :])
    return dxbar, dB, dC, dcum


class SSDIntraChunk(torch.autograd.Function):
    """``SSDIntraChunk.apply(xbar, Bh, Ch, cum) -> (y_intra, states,
    chunk_decay)``: the kernel's forward (its plain version on CPU
    tensors) and :func:`ssd_intra_chunk_bwd` as its backward."""

    @staticmethod
    def forward(ctx, xbar, Bh, Ch, cum):
        ctx.save_for_backward(xbar, Bh, Ch, cum)
        return ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)

    @staticmethod
    def backward(ctx, dy, dstates, ddecay):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy, dstates, ddecay)


def ssd_intra_chunk(
    xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor, cum: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The intra-chunk piece: through :class:`SSDIntraChunk` when grad mode
    is on and an input requires grad, else one bare kernel launch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xbar, Bh, Ch, cum)):
        return SSDIntraChunk.apply(xbar, Bh, Ch, cum)
    return ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
