"""Plain PyTorch version of the flash-attention forward kernel.

The reference's prefill attends with ``attend_full`` up to 2048 tokens and
with the blockwise online softmax above; :func:`flash_attention_ref` routes
the same way, so on the host the port computes what the reference computes.
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
) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D) in q's dtype."""
    if q.shape[1] > FULL_MAX_SEQ:
        return attend_blockwise(q, k, v, causal=causal, window=window)
    return attend_full(q, k, v, causal=causal, window=window)
