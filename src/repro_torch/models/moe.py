"""Mixture-of-Experts FFN: token-choice top-k routing with static-shape
capacity dispatch (+ optional shared experts, Qwen-style).

The port of ``repro.models.moe``.  The router runs in f32, which must be
IEEE f32 (PyTorch's default; the launch entry points check it); the (T, E)
affinity of the top-k router probabilities is reduced per expert with a
top-C selection (C = capacity), so no (T, E, C) one-hot dispatch tensor is
built.  Tokens beyond an expert's capacity are dropped for that expert.
The expert banks are ``(E, C, d) x (E, d, ff)`` batched matmuls (cuBLAS on
the card; the reference computes them outside any Pallas kernel too).

Two points where the port is stricter than a literal translation:

* **ties**: both top-k selections keep the lower index first among equal
  values, as ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
  promises no order);
* **a deterministic combine**: the reference scatter-adds the expert outputs
  into the bf16 token rows, in slot order (ascending expert id).  On CUDA an
  ``index_add_`` is atomic and its bf16 sums would change from run to run,
  so the port sums each token's kept expert outputs in ascending expert id
  through an inverse slot map, which is the reference's order; the token
  gather's backward sums a token's slots the same way, and the combine's
  backward writes each kept slot once.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import _normal, init_dense, init_swiglu, swiglu

__all__ = ["init_moe", "moe"]


def init_moe(
    cfg: Any,
    *,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """One MoE FFN's params, with ``lead`` stacking axes in front: an f32
    ``router`` (d, E), expert banks ``gate``/``up`` (E, d, ff) and ``down``
    (E, ff, d), and the shared SwiGLU expert with its (d, 1) gate when the
    config has shared experts."""
    dev = resolve_device(device)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": {"w": _normal(lead + (d, e), d**-0.5, torch.float32, generator, dev)},
        "experts": {
            "gate": _normal(lead + (e, d, ff), d**-0.5, dtype, generator, dev),
            "up": _normal(lead + (e, d, ff), d**-0.5, dtype, generator, dev),
            "down": _normal(lead + (e, ff, d), ff**-0.5, dtype, generator, dev),
        },
    }
    if cfg.n_shared_experts:
        kw = dict(dtype=dtype, lead=lead, generator=generator, device=dev)
        p["shared"] = init_swiglu(d, cfg.n_shared_experts * ff, **kw)
        p["shared_gate"] = init_dense(d, 1, **kw)
    return p


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _flat_rows(idx: torch.Tensor, rows_per_group: int) -> torch.Tensor:
    """Row indices (G, ...) into each group's ``rows_per_group`` rows, as
    indices into the groups' rows stacked (G * rows_per_group)."""
    base = torch.arange(idx.shape[0], device=idx.device) * rows_per_group
    return (idx + base.view(-1, *([1] * (idx.dim() - 1)))).reshape(-1)


def _slot_sum(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``rows`` (G, N, d), ``slot`` (G, S, k) -> (G, S, d): the sum over j
    of ``rows[g, slot[g, s, j]]`` taken in ascending j, each partial sum
    rounded in ``rows``' dtype; a slot of N reads zeros."""
    G, N, d = rows.shape
    pad = torch.cat([rows, rows.new_zeros((G, 1, d))], dim=1).reshape(G * (N + 1), d)
    out = pad.index_select(0, _flat_rows(slot[..., 0], N + 1))
    for j in range(1, slot.shape[-1]):
        out = out + pad.index_select(0, _flat_rows(slot[..., j], N + 1))
    return out.view(G, slot.shape[1], d)


def _slot_scatter(grad: torch.Tensor, slot: torch.Tensor, n: int) -> torch.Tensor:
    """The transpose of :func:`_slot_sum`: ``grad`` (G, S, d) written to
    rows ``slot[g, s, j]`` of a zero (G, n, d).  A row is written at most
    once (every kept (expert, slot) holds one token), so no atomic sum is
    needed; the dropped entries all land in row n, which is cut off."""
    G, S, k = slot.shape
    d = grad.shape[-1]
    out = grad.new_zeros((G * (n + 1), d))
    out.index_copy_(0, _flat_rows(slot, n + 1), grad[:, :, None, :].expand(G, S, k, d).reshape(G * S * k, d))
    return out.view(G, n + 1, d)[:, :n]


class _Combine(torch.autograd.Function):
    """:func:`_slot_sum` (each token's kept expert outputs in ascending
    expert id) whose backward is :func:`_slot_scatter`: autograd's own
    backward of the row gathers would add into the rows with atomics, and
    the accumulating index_put that advanced indexing takes instead sorts
    its indices and serialises the repeated dropped index (half of a
    granite-moe training step's device time on the H100)."""

    @staticmethod
    def forward(ctx, rows, slot):
        ctx.save_for_backward(slot)
        ctx.n = rows.shape[1]
        return _slot_sum(rows, slot)

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        return _slot_scatter(grad, slot, ctx.n), None


class _TokenGather(torch.autograd.Function):
    """``t[g, sel_idx[g]]`` (G, E, C, d): the dispatch, the transpose of
    the combine.  Its backward sums each token's slot gradients in
    ascending expert id through the slot map (:func:`_slot_sum`), not with
    an atomic scatter.  A slot missing from the map (a token no expert
    kept, or a filler of zero routing weight) carries an exactly zero
    gradient: its expert output is weighted by 0."""

    @staticmethod
    def forward(ctx, t, sel_idx, slot):
        ctx.save_for_backward(slot)
        G, S, d = t.shape
        return t.reshape(G * S, d).index_select(0, _flat_rows(sel_idx, S)).view(*sel_idx.shape, d)

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        G, E, C, d = grad.shape
        return _slot_sum(grad.reshape(G, E * C, d), slot), None, None


def _dispatch(t: torch.Tensor, affinity: torch.Tensor, top_idx: torch.Tensor, experts: dict,
              capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-limited dispatch and combine over G token groups.

    t (G, S, d), affinity (G, S, E), top_idx (G, S, k) -> (y (G, S, d), the
    kept assignment count)."""
    G, S, d = t.shape
    E = affinity.shape[-1]
    sel_w, sel_idx = _top_k(affinity.transpose(1, 2), capacity)             # (G, E, C)
    C = capacity
    # inverse slot map: slot[g, s, j] is the flat (expert, slot) index that
    # holds token s's j-th expert in ascending id, or E*C where it was dropped
    ids = torch.arange(E * C, device=t.device).view(1, E, C).expand(G, E, C)
    inv = torch.full((G, E, S), E * C, dtype=torch.long, device=t.device)
    inv.scatter_(2, sel_idx, torch.where(sel_w > 0, ids, E * C))
    slot = inv.transpose(1, 2).gather(2, top_idx.sort(dim=-1).values)      # (G, S, k)

    xe = _TokenGather.apply(t, sel_idx, slot).transpose(0, 1).reshape(E, G * C, d)
    h_gate = torch.bmm(xe, experts["gate"])
    h_up = torch.bmm(xe, experts["up"])
    ye = torch.bmm(F.silu(h_gate) * h_up, experts["down"])                  # (E, G*C, d)
    ye = ye.reshape(E, G, C, d).transpose(0, 1) * sel_w[..., None].to(ye.dtype)
    y = _Combine.apply(ye.reshape(G, E * C, d), slot)
    return y, (sel_w > 0).sum().float()


def moe(
    params: dict,
    x: torch.Tensor,
    cfg: Any,
    *,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MoE FFN. x (B, S, d) -> (y, aux losses ``moe_lb_loss``,
    ``moe_z_loss``, ``moe_drop_frac``).

    ``cfg.moe_local_dispatch`` routes within each sequence instead of over
    the whole batch: capacity is then per (sequence, expert).  A group of
    at most 256 tokens (decode) keeps every token: capacity = group."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    local = bool(getattr(cfg, "moe_local_dispatch", False)) and S > 1
    T = B * S
    t = x.reshape(T, d)

    logits = t.float() @ params["router"]["w"]                              # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, k)                                    # (T, k)
    if getattr(cfg, "moe_renormalize", True):
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    affinity = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter(1, top_idx, top_vals)

    group = S if local else T
    if group <= 256:
        capacity = group
    else:
        capacity = min(max(1, int(math.ceil(group * k * capacity_factor / E))), group)

    G = B if local else 1
    y, kept = _dispatch(t.reshape(G, group, d), affinity.reshape(G, group, E),
                        top_idx.reshape(G, group, k), params["experts"], capacity)
    y = y.reshape(T, d)

    if "shared" in params:
        gate = torch.sigmoid(t @ params["shared_gate"]["w"]).to(y.dtype)
        y = y + gate * swiglu(params["shared"], t)

    # ---- auxiliary losses ------------------------------------------------
    # load balance (Switch-style): E * sum_e (token fraction_e * prob mass_e) / k
    assigned = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter(
        1, top_idx, torch.ones_like(top_vals))
    frac = assigned.mean(dim=0)
    mass = probs.mean(dim=0)
    lb_loss = E * (frac * mass).sum() / k
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    # dropped (token, expert) assignment fraction: the capacity tuning signal
    drop_frac = torch.clamp(1.0 - kept / torch.clamp(assigned.sum(), min=1.0), 0.0, 1.0)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_drop_frac": drop_frac}
    return y.reshape(B, S, d).to(x.dtype), aux
