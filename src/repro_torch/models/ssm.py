"""Mamba2 (state-space duality) blocks: chunked SSD scan + O(1) decode.

The SSD algorithm splits the sequence into chunks: within a chunk the
recurrence is a (Q x Q) masked attention-like contraction
(:func:`ssd_intra_chunk`, the plain version of the SSD CUDA kernel); across
chunks only the (H, P, N) states propagate, in a loop of torch ops.
:func:`mamba2_block` runs the chunked scan through
:func:`repro_torch.kernels.ssd.ops.ssd_chunked`, which launches the kernel
on the card; :func:`ssd_decode_step` is the O(1)-state serving step.

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
from repro_torch.models.layers import init_dense, rms_norm

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
    """Prefill path. x (B, S, d) -> (y (B, S, d), final caches)."""
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
    """O(1) decode. x_t (B, 1, d), cache {conv (B,K-1,conv_dim), ssm (B,H,P,N)}."""
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
