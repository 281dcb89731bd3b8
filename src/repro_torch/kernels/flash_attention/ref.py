"""Plain PyTorch version of the flash-attention forward kernel.

The reference's prefill attends with ``attend_full`` up to 2048 tokens and
with the blockwise online softmax above; :func:`flash_attention_ref` routes
the same way, so on the host the port computes what the reference computes.
Training needs the row log-sum-exp, which only the blockwise path (the
reference's custom_vjp forward, ``_flash_fwd_impl``) gives.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import attend_blockwise, attend_full

__all__ = ["flash_attention_ref", "FULL_MAX_SEQ"]

FULL_MAX_SEQ = 2048   # above this the reference switches to the blockwise path


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D) in q's dtype, and with
    ``return_lse`` the (B,H,Sq) f32 log-sum-exp beside it."""
    if return_lse or q.shape[1] > FULL_MAX_SEQ:
        return attend_blockwise(q, k, v, causal=causal, window=window, return_lse=return_lse)
    return attend_full(q, k, v, causal=causal, window=window)
