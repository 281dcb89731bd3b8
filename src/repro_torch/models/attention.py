"""Attention: GQA + RoPE + optional qk-norm + optional sliding window.

Three paths share one set of projection weights:

* ``attend_full``      — einsum + masked softmax; the plain version of the
                         flash kernel for S <= 2048;
* ``attend_blockwise`` — online-softmax loop over key blocks, memory
                         O(S * block), optionally with the row log-sum-exp —
                         the plain version for longer sequences and for
                         training;
* ``attend_decode``    — single-query attention against a KV cache.

The model's full-sequence blocks call :func:`flash_attention`: with no
gradient needed it is the forward kernel's wrapper
(:func:`repro_torch.kernels.flash_attention.kernel.flash_attention_cuda`),
and with one it is :class:`FlashAttention`, whose forward is that kernel
with its LSE output and whose backward is the dQ and dK/dV kernels
(``kernels/flash_attention/bwd.py``) — the pairing the reference's
``_flash`` custom_vjp makes in pure JAX.  On the host each wrapper takes
its plain version.

Layouts: q (B, S, H, D), k/v (B, S, KV, D); GQA groups G = H // KV are an
explicit axis in the score einsums.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models.layers import init_dense, init_rms_norm, is_dtensor, rms_norm, rope

__all__ = [
    "init_attention",
    "split_heads",
    "attend_full",
    "attend_blockwise",
    "attend_decode",
    "flash_attention",
    "FlashAttention",
]

NEG_INF = -1e30


def init_attention(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    qk_norm: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    kw = dict(dtype=dtype, lead=lead, generator=generator, device=device)
    p = {
        "wq": init_dense(d_model, n_heads * head_dim, **kw),
        "wk": init_dense(d_model, n_kv_heads * head_dim, **kw),
        "wv": init_dense(d_model, n_kv_heads * head_dim, **kw),
        "wo": init_dense(n_heads * head_dim, d_model, **kw),
    }
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, lead=lead, device=device)
        p["k_norm"] = init_rms_norm(head_dim, lead=lead, device=device)
    return p


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d).  Under a mesh, a DTensor whose last dim
    is sharded into parts that are not whole heads (K/V with fewer heads
    than the model axis; the reference's GSPMD pads them) is gathered on
    those mesh dims first."""
    if is_dtensor(t):
        last = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim % t.ndim == t.ndim - 1]
        if n % math.prod(t.device_mesh.size(i) for i in last):
            t = t.redistribute(t.device_mesh, [Replicate() if i in last else p for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, d)


def _project_qkv(
    params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: Any
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ params["wq"]["w"], H, D)
    k = split_heads(x @ params["wk"]["w"], KV, D)
    v = split_heads(x @ params["wv"]["w"], KV, D)
    if "q_norm" in params:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KV, G, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, D)


def attend_full(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Masked softmax attention. q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D).
    Scores and softmax in f32; the probabilities are cast to v's dtype for
    the second product, as the reference does."""
    B, Sq, H, D = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    qg = _grouped(q, KV)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * D**-0.5
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def attend_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    block_k: int = 512,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward in plain PyTorch: the math of the flash
    kernel (online softmax over key blocks, f32 throughout, output in q's
    dtype), memory O(Sq * block_k).  The reference pads keys to whole
    blocks and masks the padding; slicing the ragged last block is the same
    sum.  With ``return_lse`` it also returns the row log-sum-exp
    ``m + log(max(l, 1e-30))`` as (B, H, Sq) f32, heads in the order
    ``h = kv * G + g`` (the reference's (B, KV, G, Sq) in the same memory),
    which the backward recomputes the probabilities from.  float64 inputs
    are computed in float64 (for gradient checks), all others in f32."""
    B, Sq, H, D = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = H // KV
    scale = D**-0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = _grouped(q, KV).to(ct)
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=ct, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=ct, device=q.device)
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
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe)).reshape(B, H, Sq)
    return out


def attend_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-step attention against a cache. q (B,1,H,D), caches
    (B,Smax,KV,D); ``cache_len`` (B,) counts the valid entries, the new
    token's included.  Under a mesh each rank attends over its shards of
    the cache (:func:`_decode_on_shards`)."""
    if is_dtensor(k_cache):
        return _decode_on_shards(q, k_cache, v_cache, cache_len, window)
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    qg = _grouped(q, KV).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * D**-0.5
    pos_k = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    mask = pos_k < cache_len[:, None]
    if window is not None:
        mask &= pos_k >= cache_len[:, None] - window
    s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a flash backward: ``FlashAttention.apply(q, k, v,
    causal, window)``.  The forward saves ``(q, k, v, out, lse)``, no
    O(S^2) residual; the backward recomputes the probabilities from them.
    Kernels on CUDA tensors, plain versions on CPU tensors (the wrappers
    decide by device)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        # imported here: the kernels' plain versions import this module
        from repro_torch.kernels.flash_attention import kernel

        out, lse = kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention import bwd

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D).  Through
    :class:`FlashAttention` when a gradient is needed; otherwise one
    forward launch without the LSE, as serving runs it."""
    from repro_torch.kernels.flash_attention import kernel

    if is_dtensor(q):
        return _attend_on_shards(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Under a mesh: attention as plain code on each rank's shards
# ---------------------------------------------------------------------------


def _attend_on_shards(q, k, v, **kw):
    """:func:`flash_attention` on each rank's batch rows and query heads,
    whole sequences.  K/V take q's layout where their heads split like q's;
    otherwise (fewer KV heads than ranks on the heads' mesh dims) they are
    gathered there and each rank reads the KV heads of its own query heads
    (:func:`repro_torch.compat.for_heads`), not those of its local head
    indices."""
    from repro_torch import compat

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    pq = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements]
    heads = [i for i, p in enumerate(pq) if p == Shard(2)]
    ext = math.prod(mesh.size(i) for i in heads)
    if H % ext == 0 and KV % ext == 0:
        q_l, k_l, v_l = (compat.local(t, pq) for t in (q, k, v))
    else:
        pk = [Replicate() if i in heads else p for i, p in enumerate(pq)]
        grad = [Partial() if i in heads else p for i, p in enumerate(pq)]
        h0, hl = compat.span(q, 2, pq)
        q_l = compat.local(q, pq)
        k_l, v_l = (compat.for_heads(compat.local(t, pk, grad), 2, h0, hl, H // KV) for t in (k, v))
    return compat.wrap(flash_attention(q_l, k_l, v_l, **kw), mesh, pq, q.shape)


def _decode_on_shards(q, k_cache, v_cache, cache_len, window):
    """:func:`attend_decode` on each rank's shards of the cache: q takes the
    cache's batch and KV-head layout.  Where the cache's sequence axis is
    sharded (sequence parallelism for batch-1 caches, or the model axis
    when the KV heads do not divide it) every rank scores its own slots and
    the softmax is combined across them: the global row max first, then
    the sums of the rescaled weights and values."""
    from repro_torch import compat

    mesh = k_cache.device_mesh
    pc = k_cache.placements
    seq = [i for i, p in enumerate(pc) if p == Shard(1)]
    pq = [p if p in (Shard(0), Shard(2)) else Replicate() for p in pc]
    q_l, k_l, v_l = compat.local(q, pq), compat.local(k_cache, pc), compat.local(v_cache, pc)
    b0, bl = compat.span(k_cache, 0)
    lens = (compat.local(cache_len, [Replicate()] * mesh.ndim) if is_dtensor(cache_len) else cache_len)[b0 : b0 + bl]
    if not seq:
        out = attend_decode(q_l, k_l, v_l, lens, window=window)
    else:
        s0, sl = compat.span(k_cache, 1)
        qg = _grouped(q_l, k_l.shape[2]).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_l.float()) * q.shape[-1] ** -0.5
        pos_k = s0 + torch.arange(sl, device=q_l.device)[None, :]
        mask = pos_k < lens[:, None]
        if window is not None:
            mask &= pos_k >= lens[:, None] - window
        s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
        m = compat.reduce_over(s.amax(dim=-1, keepdim=True), mesh, seq, "max")
        p = torch.exp(s - m)
        num = compat.reduce_over(torch.einsum("bhgqk,bkhd->bqhgd", p, v_l.float()), mesh, seq)
        den = compat.reduce_over(p.sum(dim=-1), mesh, seq)                         # (b, h, g, q)
        out = (num / den.permute(0, 3, 1, 2)[..., None]).reshape(q_l.shape).to(q.dtype)
    return compat.wrap(out, mesh, pq, q.shape)
