"""Plain PyTorch version of the flash-attention backward kernels.

A port of the reference's recompute-based custom_vjp backward
(``repro.models.attention._flash_bwd``): a loop over key blocks that
recomputes the probabilities from ``(q, k, lse)``, f32 throughout, memory
O(Sq * block_k).  The reference pads keys to whole blocks and masks the
padding; slicing the ragged last block is the same sum.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, _grouped

__all__ = ["flash_attention_bwd_ref", "attention_delta"]


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta_i = dO_i . O_i`` in f32 (float64 for float64 inputs),
    (B,Sq,H,D) -> (B,H,Sq)."""
    ct = torch.promote_types(do.dtype, torch.float32)
    return (do.to(ct) * out.to(ct)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor | None,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    block_k: int = 512,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/out/do (B,Sq,H,D), k/v (B,Sk,KV,D), lse (B,H,Sq) f32 (the
    forward's, heads ``h = kv * G + g``) -> (dq, dk, dv) in the inputs'
    layouts and dtypes.  ``out`` enters only through
    :func:`attention_delta`; a caller that has delta passes it instead.
    float64 inputs are computed in float64, all others in f32."""
    B, Sq, H, D = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = H // KV
    scale = D**-0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = _grouped(q, KV).to(ct)
    dg_t = _grouped(do, KV).to(ct).permute(0, 2, 3, 1, 4)            # (B,KV,G,Sq,D)
    delta = (attention_delta(out, do) if delta is None else delta).reshape(B, KV, G, Sq)
    lse = lse.reshape(B, KV, G, Sq).to(ct)
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    dq = torch.zeros((B, Sq, KV, G, D), dtype=ct, device=q.device)
    dk = torch.empty((B, Sk, KV, D), dtype=ct, device=q.device)
    dv = torch.empty((B, Sk, KV, D), dtype=ct, device=q.device)
    for k0 in range(0, Sk, block_k):
        k_blk = k[:, k0 : k0 + block_k].to(ct)
        v_blk = v[:, k0 : k0 + block_k].to(ct)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk) * scale
        pos_k = k0 + torch.arange(k_blk.shape[1], device=q.device)[None, :]
        mask = torch.ones((Sq, k_blk.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos_q >= pos_k
        if window is not None:
            mask &= pos_q - pos_k < window
        p = torch.exp(s.masked_fill(~mask, NEG_INF) - lse[..., None])  # (B,KV,G,Sq,bk)
        dv[:, k0 : k0 + block_k] = torch.einsum("bhgqk,bhgqd->bkhd", p, dg_t)
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dg_t, v_blk)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
        dk[:, k0 : k0 + block_k] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
