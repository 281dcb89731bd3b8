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
from repro_torch.models.layers import _normal, init_dense, init_swiglu, is_dtensor, swiglu

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
    rows: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MoE FFN. x (B, S, d) -> (y, aux losses ``moe_lb_loss``,
    ``moe_z_loss``, ``moe_drop_frac``).

    ``cfg.moe_local_dispatch`` routes within each sequence instead of over
    the whole batch: capacity is then per (sequence, expert).  A group of
    at most 256 tokens (decode) keeps every token: capacity = group.
    ``rows``: under a mesh, the real rows of a batch padded to the data
    extent (:func:`repro_torch.compat.pad_rows`); capacity counts only
    their tokens, and the padding rows take no slot and enter no aux term."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    local = bool(getattr(cfg, "moe_local_dispatch", False)) and S > 1
    n = B if rows is None else rows
    group = S if local else n * S
    if group <= 256:
        capacity = group
    else:
        capacity = min(max(1, int(math.ceil(group * k * capacity_factor / E))), group)
    if is_dtensor(x):
        return _moe_on_shards(params, x, cfg, S if local else B * S, capacity, n)
    T = B * S
    t = x.reshape(T, d)

    logits, probs, top_idx, affinity, assigned = _route(t, params["router"]["w"], cfg)
    G = B if local else 1
    y, kept = _dispatch(t.reshape(G, group, d), affinity.reshape(G, group, E),
                        top_idx.reshape(G, group, k), params["experts"], capacity)
    y = y.reshape(T, d)

    if "shared" in params:
        gate = torch.sigmoid(t @ params["shared_gate"]["w"]).to(y.dtype)
        y = y + gate * swiglu(params["shared"], t)

    # ---- auxiliary losses ------------------------------------------------
    # load balance (Switch-style): E * sum_e (token fraction_e * prob mass_e) / k
    frac = assigned.mean(dim=0)
    mass = probs.mean(dim=0)
    lb_loss = E * (frac * mass).sum() / k
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    # dropped (token, expert) assignment fraction: the capacity tuning signal
    drop_frac = torch.clamp(1.0 - kept / torch.clamp(assigned.sum(), min=1.0), 0.0, 1.0)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_drop_frac": drop_frac}
    return y.reshape(B, S, d).to(x.dtype), aux


def _route(t: torch.Tensor, router: torch.Tensor, cfg: Any):
    """The f32 router over token rows t (T, d): (logits, probs, top-k expert
    ids (T, k), the affinity (T, E) of the kept top-k probabilities, the
    one-hot assignment (T, E))."""
    E, k = cfg.n_experts, cfg.top_k
    logits = t.float() @ router                                             # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, k)                                    # (T, k)
    if getattr(cfg, "moe_renormalize", True):
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    zeros = torch.zeros((t.shape[0], E), dtype=torch.float32, device=t.device)
    return (logits, probs, top_idx, zeros.scatter(1, top_idx, top_vals),
            zeros.scatter(1, top_idx, torch.ones_like(top_vals)))


def _moe_on_shards(params: dict, x: torch.Tensor, cfg: Any, group: int, capacity: int, n: int):
    """:func:`moe` under a mesh, as plain code on each rank's shards.

    Tokens are the rows of the batch, sharded over the data axes; ``group``
    is the token positions of a routing group, ``n`` the real rows of a
    padded batch.  Each rank routes its own rows; the routing bookkeeping
    (the top-C tokens of each expert within each group, the inverse slot
    map) is computed on the gathered affinity, so global dispatch stays
    global over all B·S tokens.  A padding row's affinity is -1 there:
    every real token sorts before it, so with C at most a group's real
    tokens it takes no slot, and the real tokens' top-C (ties included) is
    the unpadded one.  The (expert, slot) axis is sharded over the data
    axes: each rank gathers the tokens of its slots, the expert banks run
    as DTensor bmms (their hidden dim over ``model``), and each rank adds
    its slots' weighted outputs into every token row in ascending expert
    id; those partial sums are reduce-scattered back to the token rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch import compat

    mesh = x.device_mesh
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T, C = B * S, capacity
    G = T // group
    rows = compat.batch_placements(mesh, B)                        # the batch rows over the data axes
    data = [p == Shard(0) for p in rows]
    data_dims = [i for i, dp in enumerate(data) if dp]
    full = [Replicate()] * mesh.ndim
    partial = [Partial() if dp else Replicate() for dp in data]   # each data rank's part of a gathered tensor

    def gather(t_l: torch.Tensor, grad=None) -> torch.Tensor:
        """(rows of this rank, S, ...) -> (T, ...) of every rank."""
        g = compat.local(compat.wrap(t_l, mesh, rows, (B, *t_l.shape[1:])), full, grad)
        return g.reshape(T, *g.shape[2:])

    x_l = compat.local(x, rows)
    t_l = x_l.reshape(-1, d)
    logits, probs, top_idx, affinity, assigned = _route(t_l, compat.local(params["router"]["w"], full, partial), cfg)
    aff = gather(affinity.view(-1, S, E), partial)                          # (T, E)
    ids = gather(top_idx.sort(dim=-1).values.view(-1, S, k))                # (T, k), ascending expert id
    z = torch.logsumexp(logits, dim=-1) ** 2
    if n < B:   # a padded batch: its padding rows sort after every real token and count in no aux term
        real = compat.real_row_mask(mesh, n, B, x.device)
        aff = torch.where(real.repeat_interleave(S)[:, None], aff, -1.0)
        b0 = compat.box((B,), mesh, rows)[1][0]
        real_l = real[b0 : b0 + x_l.shape[0]].repeat_interleave(S).float()
        assigned, probs, z = assigned * real_l[:, None], probs * real_l[:, None], z * real_l

    # every group's top-C tokens per expert and its inverse slot map: the
    # kept slot p = g * C + c of each token's experts in ascending id, or -1
    sel_w, sel_idx = _top_k(aff.view(G, group, E).transpose(1, 2), C)      # (G, E, C)
    slot_ids = torch.arange(G * C, device=aff.device).view(G, 1, C).expand(G, E, C)
    inv = torch.full((G, E, group), -1, dtype=torch.long, device=aff.device)
    inv.scatter_(2, sel_idx, torch.where(sel_w > 0, slot_ids, -1))
    p = inv.transpose(1, 2).gather(2, ids.view(G, group, k)).view(T, k)

    # this rank's slots [s0, s0 + sl) of each expert's G * C
    slots = [Shard(1) if dp else Replicate() for dp in data]
    (_, sl, _), (_, s0, _) = compat.box((E, G * C, d), mesh, slots)
    mine = (p >= s0) & (p < s0 + sl)
    slot = torch.where(mine, ids * sl + p - s0, E * sl)[None]             # (1, T, k) into the E * sl local rows
    token = (sel_idx + (torch.arange(G, device=aff.device) * group).view(G, 1, 1)).transpose(0, 1)
    token = token.reshape(E, G * C)[:, s0 : s0 + sl]                       # the token row of each local slot
    w_l = sel_w.transpose(0, 1).reshape(E, G * C)[:, s0 : s0 + sl]

    xe = _TokenGather.apply(gather(x_l, partial)[None], token[None], slot).view(E, sl, d)
    xe = compat.wrap(xe, mesh, slots, (E, G * C, d))
    experts = params["experts"]
    h = F.silu(torch.bmm(xe, experts["gate"])) * torch.bmm(xe, experts["up"])
    ye = compat.local(torch.bmm(h, experts["down"]), slots)                # (E, sl, d)
    ye = ye * w_l[..., None].to(ye.dtype)
    y_part = _Combine.apply(ye.reshape(1, E * sl, d), slot).view(B, S, d)  # this rank's slots, every token
    y = compat.wrap(y_part, mesh, partial, (B, S, d))
    y = y.redistribute(mesh, rows)
    if "shared" in params:
        gate = torch.sigmoid(x @ params["shared_gate"]["w"]).to(y.dtype)
        y = y + gate * swiglu(params["shared"], x)

    # ---- auxiliary losses: sums over every rank's real rows ----------------
    sums = compat.reduce_over(torch.cat([assigned.sum(0), probs.sum(0)]), mesh, data_dims)
    frac, mass = sums[:E] / (n * S), sums[E:] / (n * S)
    z_sum = compat.reduce_over(z.sum(), mesh, data_dims)
    kept = (sel_w > 0).sum().float()
    drop_frac = torch.clamp(1.0 - kept / torch.clamp(sums[:E].sum(), min=1.0), 0.0, 1.0)
    aux = {"moe_lb_loss": E * (frac * mass).sum() / k, "moe_z_loss": z_sum / (n * S), "moe_drop_frac": drop_frac}
    return y.to(x.dtype), {name: compat.wrap(v, mesh, full, ()) for name, v in aux.items()}
