"""Mamba2 (state-space duality) blocks: chunked SSD scan + O(1) decode.

The SSD algorithm splits the sequence into chunks: within a chunk the
recurrence is a (Q x Q) masked attention-like contraction
(:func:`ssd_intra_chunk`, the plain version of the SSD CUDA kernel); across
chunks only the (H, P, N) states propagate, in a loop of torch ops.
:func:`mamba2_block` runs the chunked scan through
:func:`repro_torch.kernels.ssd.ops.ssd_chunked`, which launches the kernel
on the card (under autograd through
:class:`~repro_torch.kernels.ssd.bwd.SSDIntraChunk`, whose backward is the
closed-form gradient); :func:`ssd_decode_step` is the O(1)-state serving
step.

Shapes: x (B, L, H, P), dt (B, L, H), A (H,), B/C (B, L, G, N); G (state
groups) broadcasts over heads.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref as ssd_intra_chunk
from repro_torch.models.layers import init_dense, is_dtensor, rms_norm

__all__ = [
    "ssd_intra_chunk",
    "ssd_chunked",
    "ssd_decode_step",
    "init_mamba2_block",
    "mamba2_block",
    "mamba2_decode_step",
    "mamba2_state_shape",
]


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain PyTorch.  Returns (y (B,L,H,P),
    final_state (B,H,P,N))."""
    return ssd_ops.ssd_chunked(
        x, dt, A, B, C, chunk=chunk, initial_state=initial_state, intra_chunk=ssd_intra_chunk
    )


def ssd_decode_step(
    state: torch.Tensor,
    x_t: torch.Tensor,
    dt_t: torch.Tensor,
    A: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state (B,H,P,N), x_t (B,H,P), dt_t (B,H),
    B_t/C_t (B,G,N). Returns (y_t (B,H,P), new_state)."""
    b, h, p, n = state.shape
    g = B_t.shape[1]
    Bh = B_t[:, :, None, :].expand(b, g, h // g, n).reshape(b, h, n).float()
    Ch = C_t[:, :, None, :].expand(b, g, h // g, n).reshape(b, h, n).float()
    dA = torch.exp(dt_t.float() * A.float())                     # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt_t.float(), x_t.float(), Bh)
    new_state = dA[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> conv1d -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def _dims(cfg: Any) -> tuple[int, int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    head_p = cfg.ssm_head_dim
    return d_inner, d_inner // head_p, head_p, cfg.ssm_groups, cfg.ssm_state


def mamba2_state_shape(cfg: Any, batch: int) -> dict[str, tuple]:
    d_inner, n_heads, head_p, g, n = _dims(cfg)
    return {
        "conv": (batch, cfg.ssm_conv - 1, d_inner + 2 * g * n),
        "ssm": (batch, n_heads, head_p, n),
    }


def init_mamba2_block(
    cfg: Any,
    *,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """One Mamba2 block's params, with ``lead`` stacking axes in front."""
    dev = resolve_device(device)
    d = cfg.d_model
    d_inner, n_heads, head_p, g, n = _dims(cfg)
    conv_dim = d_inner + 2 * g * n
    in_dim = 2 * d_inner + 2 * g * n + n_heads   # z, x, B, C, dt
    kw = dict(dtype=dtype, lead=lead, generator=generator, device=dev)
    conv_w = torch.randn(lead + (cfg.ssm_conv, conv_dim), generator=generator, device=dev, dtype=dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev))
    return {
        "in_proj": init_dense(d, in_dim, **kw),
        "conv_w": conv_w.mul_(1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "a_log": a_log.expand(lead + (n_heads,)).clone(),
        "dt_bias": torch.rand(lead + (n_heads,), generator=generator, device=dev).mul_(3.0).sub_(4.0),
        "d_skip": torch.ones(lead + (n_heads,), device=dev),
        "norm_scale": torch.ones(lead + (d_inner,), device=dev),
        "out_proj": init_dense(d_inner, d, **kw),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: Any):
    d_inner, n_heads, head_p, g, n = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, n_heads], dim=-1)


def mamba2_block(params: dict, x: torch.Tensor, cfg: Any) -> tuple[torch.Tensor, dict]:
    """Prefill path. x (B, S, d) -> (y (B, S, d), final caches).  Under a
    mesh each rank runs its own heads (:func:`_block_on_shards`)."""
    if is_dtensor(x):
        return _block_on_shards(params, x, cfg)
    Bsz, S, _ = x.shape
    d_inner, n_heads, head_p, g, n = _dims(cfg)
    z, xbc, dt = _split_proj(x @ params["in_proj"]["w"], cfg)

    # causal depthwise conv over (x, B, C)
    w = params["conv_w"]                                         # (K, conv_dim)
    K = w.shape[0]
    xbc_pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = xbc_pad[:, 0:S, :] * w[0]
    for i in range(1, K):
        conv = conv + xbc_pad[:, i : i + S, :] * w[i]
    conv = F.silu(conv + params["conv_b"])

    xs, Bmat, Cmat = torch.split(conv, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(Bsz, S, n_heads, head_p)
    Bmat = Bmat.reshape(Bsz, S, g, n)
    Cmat = Cmat.reshape(Bsz, S, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])

    y, final_state = ssd_ops.ssd_chunked(xs, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xs.to(y.dtype)
    y = y.reshape(Bsz, S, d_inner)
    y = rms_norm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = (y @ params["out_proj"]["w"]).to(x.dtype)
    # a copy, so the cache does not keep the whole projection alive
    return out, {"conv": xbc[:, -(K - 1) :, :].clone(), "ssm": final_state}


def mamba2_decode_step(
    params: dict, x_t: torch.Tensor, cache: dict, cfg: Any
) -> tuple[torch.Tensor, dict]:
    """O(1) decode. x_t (B, 1, d), cache {conv (B,K-1,conv_dim), ssm (B,H,P,N)}.
    Under a mesh each rank updates its shards of the cache
    (:func:`_decode_on_shards`)."""
    if is_dtensor(x_t):
        return _decode_on_shards(params, x_t, cache, cfg)
    Bsz = x_t.shape[0]
    d_inner, n_heads, head_p, g, n = _dims(cfg)
    z, xbc, dt = _split_proj(x_t[:, 0, :] @ params["in_proj"]["w"], cfg)

    w = params["conv_w"]
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, K, conv)
    conv = F.silu(torch.einsum("bkc,kc->bc", window, w) + params["conv_b"])

    xs, Bmat, Cmat = torch.split(conv, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(Bsz, n_heads, head_p)
    Bmat = Bmat.reshape(Bsz, g, n)
    Cmat = Cmat.reshape(Bsz, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])

    y, new_ssm = ssd_decode_step(cache["ssm"], xs, dt, A, Bmat, Cmat)
    y = y + params["d_skip"].to(y.dtype)[None, :, None] * xs.to(y.dtype)
    y = y.reshape(Bsz, d_inner)
    y = rms_norm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = (y @ params["out_proj"]["w"]).to(x_t.dtype)[:, None, :]
    return out, {"conv": window[:, 1:, :].to(cache["conv"].dtype), "ssm": new_ssm}


# ---------------------------------------------------------------------------
# Under a mesh: the per-head work as plain code on each rank's heads
# ---------------------------------------------------------------------------


def _block_on_shards(params: dict, x: torch.Tensor, cfg: Any) -> tuple[torch.Tensor, dict]:
    """:func:`mamba2_block` under a mesh.  The in_proj columns of z, x and
    dt interleave with B and C, so its model-sharded output does not split
    on shard edges; instead each rank gathers the weight and projects its
    batch rows onto its own heads' columns (and the B / C groups they read),
    runs the conv, the SSD scan and the gated norm on them (the norm's mean
    square summed over the heads' ranks), and the out_proj is a DTensor
    matmul over the heads' shards.  The heads shard over ``model`` when it
    divides them, as ``cache_shardings`` lays out the SSM state."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch import compat

    mesh = x.device_mesh
    Bsz, S, _ = x.shape
    d_inner, H, P, g, n = _dims(cfg)
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    rows = compat.batch_placements(mesh, Bsz)
    heads = [Shard(1) if a == "model" and H % m == 0 else p for a, p in zip(mesh.mesh_dim_names, rows)]
    # a gathered weight's gradient: summed over the ranks that each use their own rows or heads of it
    part = [Replicate() if p == Replicate() else Partial() for p in heads]
    full = [Replicate()] * mesh.ndim
    model = [i for i, a in enumerate(mesh.mesh_dim_names) if a == "model" and H % m == 0]
    (_, hl), (_, h0) = compat.box((Bsz, H), mesh, heads)
    per = H // g                                  # heads a B / C group
    g0, g1 = h0 // per, -(-(h0 + hl) // per)      # the groups this rank's heads read
    gn = g1 - g0
    conv_idx = [(h0 * P, (h0 + hl) * P), (d_inner + g0 * n, d_inner + g1 * n),
                (d_inner + (g + g0) * n, d_inner + (g + g1) * n)]
    x_grad = [r if r == Shard(0) else q for r, q in zip(rows, part)]
    x_l = compat.local(x, rows, x_grad)
    W = compat.local(params["in_proj"]["w"], full, part)
    dt_c = 2 * d_inner + 2 * g * n + h0
    W_sel = torch.cat([W[:, a:b] for a, b in [conv_idx[0]] + [(d_inner + a, d_inner + b) for a, b in conv_idx]
                       + [(dt_c, dt_c + hl)]], dim=1)
    z, xbc, dt = torch.split(x_l @ W_sel, [hl * P, hl * P + 2 * gn * n, hl], dim=-1)

    w = torch.cat([compat.local(params["conv_w"], full, part)[:, a:b] for a, b in conv_idx], dim=-1)
    cb = torch.cat([compat.local(params["conv_b"], full, part)[a:b] for a, b in conv_idx], dim=-1)
    K = w.shape[0]
    xbc_pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = xbc_pad[:, 0:S, :] * w[0]
    for i in range(1, K):
        conv = conv + xbc_pad[:, i : i + S, :] * w[i]
    conv = F.silu(conv + cb)

    xs, Bmat, Cmat = torch.split(conv, [hl * P, gn * n, gn * n], dim=-1)
    bl = xs.shape[0]
    xs = xs.reshape(bl, S, hl, P)
    Bmat = compat.for_heads(Bmat.reshape(bl, S, gn, n), 2, h0 - g0 * per, hl, per)
    Cmat = compat.for_heads(Cmat.reshape(bl, S, gn, n), 2, h0 - g0 * per, hl, per)
    vec = {name: compat.local(params[name], full, part)[h0 : h0 + hl] for name in ("dt_bias", "a_log", "d_skip")}
    dt = F.softplus(dt.float() + vec["dt_bias"])
    A = -torch.exp(vec["a_log"])

    y, final_state = ssd_ops.ssd_chunked(xs, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk)
    y = y + vec["d_skip"].to(y.dtype)[None, None, :, None] * xs.to(y.dtype)
    y = y.reshape(bl, S, hl * P)
    # the gated RMSNorm over the whole d_inner: mean squares summed over the heads' ranks
    v = (y * F.silu(z)).float()
    var = compat.reduce_over((v * v).sum(dim=-1, keepdim=True), mesh, model, own=True) / d_inner
    scale = compat.local(params["norm_scale"], full, part)[h0 * P : (h0 + hl) * P]
    y = (v * torch.rsqrt(var + 1e-5) * scale.float()).to(y.dtype)
    y = compat.wrap(y, mesh, [Shard(2) if p == Shard(1) else p for p in heads], (Bsz, S, d_inner))
    out = (y @ params["out_proj"]["w"]).to(x.dtype)
    with torch.no_grad():   # the caches: the conv's input over the last K - 1 positions, every channel
        tail = x_l[:, -(K - 1) :, :] @ W[:, d_inner : 2 * d_inner + 2 * g * n]
        conv_state = compat.wrap(tail, mesh, rows, (Bsz, K - 1, d_inner + 2 * g * n))
        ssm_state = compat.wrap(final_state, mesh, heads, (Bsz, H, P, final_state.shape[-1]))
    return out, {"conv": conv_state, "ssm": ssm_state}


def _decode_on_shards(params: dict, x_t: torch.Tensor, cache: dict, cfg: Any) -> tuple[torch.Tensor, dict]:
    """:func:`mamba2_decode_step` under a mesh, in the cache's layouts: the
    conv state by channels (``cache_shardings``), the SSM state by heads.
    The one-token projections are gathered (a few KB a row); each rank
    steps its conv channels and its heads' states, and the conv output and
    the heads' outputs are gathered for the next op."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import compat

    mesh = x_t.device_mesh
    d_inner, H, P, g, n = _dims(cfg)
    pc, ps = cache["conv"].placements, cache["ssm"].placements
    rows = [p if p == Shard(0) else Replicate() for p in ps]
    full = [Replicate()] * mesh.ndim
    B = x_t.shape[0]
    z, xbc, dt = _split_proj(compat.local(x_t[:, 0, :] @ params["in_proj"]["w"], rows), cfg)

    c0, cl = compat.span(cache["conv"], 2)
    chan = [Shard(1) if p == Shard(2) else Replicate() for p in pc]
    chan_rows = [Shard(0) if r == Shard(0) else c for r, c in zip(rows, chan)]
    w = compat.local(params["conv_w"], chan)
    cb = compat.local(params["conv_b"], [Shard(0) if p == Shard(1) else p for p in chan])
    window = torch.cat([compat.local(cache["conv"], pc), xbc[:, None, c0 : c0 + cl]], dim=1)
    conv = F.silu(torch.einsum("bkc,kc->bc", window, w) + cb)
    conv = compat.local(compat.wrap(conv, mesh, chan_rows, (B, d_inner + 2 * g * n)), rows)

    xs, Bmat, Cmat = torch.split(conv, [d_inner, g * n, g * n], dim=-1)
    h0, hl = compat.span(cache["ssm"], 1)
    bl = xs.shape[0]
    xs = xs.reshape(bl, H, P)[:, h0 : h0 + hl]
    Bmat = compat.for_heads(Bmat.reshape(bl, g, n), 1, h0, hl, H // g)
    Cmat = compat.for_heads(Cmat.reshape(bl, g, n), 1, h0, hl, H // g)
    vec = {name: compat.local(params[name], full)[h0 : h0 + hl] for name in ("dt_bias", "a_log", "d_skip")}
    dt = F.softplus(dt[:, h0 : h0 + hl].float() + vec["dt_bias"])
    A = -torch.exp(vec["a_log"])

    y, new_ssm = ssd_decode_step(compat.local(cache["ssm"], ps), xs, dt, A, Bmat, Cmat)
    y = y + vec["d_skip"].to(y.dtype)[None, :, None] * xs.to(y.dtype)
    y = compat.local(compat.wrap(y.reshape(bl, hl * P), mesh, ps, (B, d_inner)), rows)   # heads -> d_inner
    y = rms_norm({"scale": compat.local(params["norm_scale"], full)}, y * F.silu(z))
    out = (compat.wrap(y, mesh, rows, (B, d_inner)) @ params["out_proj"]["w"]).to(x_t.dtype)[:, None, :]
    return out, {"conv": compat.wrap(window[:, 1:, :].to(cache["conv"].dtype), mesh, pc, cache["conv"].shape),
                 "ssm": compat.wrap(new_ssm, mesh, ps, cache["ssm"].shape)}
