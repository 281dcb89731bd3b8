"""Int8 gradient compression with error feedback, the port of
``repro.training.compression`` (an option for bandwidth-constrained links,
e.g. the cross-host ``data`` / ``pod`` axes).

Scheme (1-bit-Adam family, int8 variant):

    q_t     = quantize(g_t + e_{t-1})          # per-leaf symmetric int8
    e_t     = (g_t + e_{t-1}) - dequant(q_t)   # residual kept locally
    g_used  = mean over ranks of dequant(q_t)

Error feedback keeps the *accumulated* quantisation error bounded, so SGD /
Adam converge at the uncompressed rate.  The leaf numerics are
:func:`repro_torch.models.quant.quantize_leaf_symmetric` /
:func:`~repro_torch.models.quant.dequantize_leaf`, the int8 heads' own
(``torch.round`` rounds half to even, as ``jnp.round`` does).
:func:`sync_grads_compressed` takes the mean with an ``all_reduce`` of the
dequantised f32 over the mesh's data group (a sum of int8 payloads would
overflow); on one rank it is the round trip alone.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.quant import dequantize_leaf, quantize_leaf_symmetric
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_error_state", "compress_decompress", "sync_grads_compressed"]


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_decompress(grads: Any, error: Any) -> tuple[Any, Any, dict[str, torch.Tensor]]:
    """Error-feedback int8 round trip; returns (g_hat, new_error, metrics)."""

    def one(g, e):
        x = g.float() + e
        q, scale = quantize_leaf_symmetric(x)
        deq = dequantize_leaf(q, scale)
        return deq, x - deq

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    g_hat = tree_unflatten(grads, [o[0] for o in outs])
    new_e = tree_unflatten(grads, [o[1] for o in outs])
    err_norm = torch.sqrt(sum(torch.sum(o[1] ** 2) for o in outs))
    return g_hat, new_e, {"compression_error_norm": err_norm}


def sync_grads_compressed(grads: Any, error: Any, mesh, axes: tuple[str, ...]):
    """Compressed gradient mean over the mesh ``axes``: the round trip, then
    an ``all_reduce`` of each dequantised leaf over the axes' group / n."""
    g_hat, new_e, metrics = compress_decompress(grads, error)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in axes:
        n *= sizes[a]
    if n == 1:
        return g_hat, new_e, metrics
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[tuple(axes)]._flatten()
    group = sub.get_group()
    for g in tree_leaves(g_hat):
        dist.all_reduce(g, group=group)
        g.div_(n)
    return g_hat, new_e, metrics
