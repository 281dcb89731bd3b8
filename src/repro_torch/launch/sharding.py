"""Per-architecture sharding rules, the port of ``repro.launch.sharding``:
DP / FSDP / TP / SP as DTensor placements.

Strategy (the reference's):

* **FSDP** over the ``data`` axis: every matmul weight shards its *input*
  (reduction) dimension over ``data``;
* **TP** over the ``model`` axis: attention heads / FFN hidden / expert FFN
  hidden / Mamba inner channels;
* **DP** additionally over ``pod`` (multi-pod): the batch is sharded over
  ``(pod, data)``;
* **SP** (sequence sharding) for the batch=1 ``long_500k`` decode cells: the
  KV-cache sequence axis shards over ``data``.

The rules are the reference's regexes over the same parameter paths (the
port's trees use the reference's leaf paths).  Each function returns a tree
of :class:`Layout` — the mesh and one ``Shard(d)`` / ``Replicate()``
placement per mesh dim — where the reference returns ``NamedSharding``\\ s;
:func:`spec_of` turns a layout back into the reference's
``PartitionSpec``-shaped tuple of axis names.  :class:`Layout`,
:func:`layout_for` and :func:`distribute` (a tree of tensors placed as
DTensors) live in :mod:`repro_torch.compat`, beside the ambient mesh, so
that the models use them without importing this layer; they are
re-exported here.  Where the reference leaves uneven
sharding to GSPMD's padding, DTensor shards unevenly.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from repro_torch.compat import Layout, distribute, layout_for  # noqa: F401 (re-exported)
from repro_torch.launch.mesh import axis_sizes, data_axes
from repro_torch.training.tree import tree_leaves, tree_unflatten

__all__ = [
    "ShardingPolicy",
    "Layout",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "spec_of",
    "layout_for",
    "distribute",
]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True           # shard weight reduction dims over 'data'
    tp: bool = True             # shard heads/hidden over 'model'
    expert_parallel: bool = False  # shard the expert axis over 'model' (needs E % axis == 0)
    expert_tp: bool = True      # TP the expert ff dim (off: replicate-at-use)
    seq_shard_batch1: bool = True  # SP for batch-1 decode caches

    def d(self) -> str | None:  # FSDP axis
        return "data" if self.fsdp else None

    def m(self) -> str | None:  # TP axis
        return "model" if self.tp else None


# Trailing-dims rules: suffix regex -> spec over trailing dims.  Leading
# stacked-layer/group dims are padded with None.
def _rules(p: ShardingPolicy) -> list[tuple[str, tuple]]:
    d, m = p.d(), p.m()
    ep = m if p.expert_parallel else None
    # expert ff dim: TP unless EP owns the model axis or expert_tp disabled
    ef = None if (p.expert_parallel or not p.expert_tp) else m
    return [
        (r"embed/table$", (None, d)),
        (r"unembed/table$", (None, d)),
        (r"shared_gate/w$", (d, None)),        # before the generic gate rule
        (r"(?:^|/)(wq|wk|wv)/w$", (d, m)),
        (r"(?:^|/)wo/w$", (m, d)),
        (r"(?:^|/)(gate|up|w1)/w$", (d, m)),   # swiglu/mlp/projector up
        (r"(?:^|/)(down|w2)/w$", (m, d)),
        (r"experts/(gate|up)$", (ep, d, ef)),
        (r"experts/down$", (ep, ef, d)),
        (r"router/w$", (d, None)),
        (r"in_proj/w$", (d, m)),
        (r"out_proj/w$", (m, d)),
        (r"conv_w$", (None, m)),
        (r"conv_b$", (m,)),
        (r"(a_log|dt_bias|d_skip|norm_scale)$", ()),
        (r"src_proj/w$", (d, m)),
        (r"scale$", ()),
    ]


def _spec_for(path_str: str, ndim: int, rules) -> tuple:
    for pattern, trailing in rules:
        if re.search(pattern, path_str):
            if len(trailing) > ndim:
                trailing = trailing[len(trailing) - ndim :]
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return ()  # replicate by default (norm scales etc.)


def spec_of(layout: Layout, ndim: int) -> tuple:
    """A layout as a ``PartitionSpec``-shaped tuple of length ``ndim``:
    ``None``, an axis name, or a tuple of axis names (in mesh order) per
    tensor dim."""
    per_dim: list[list[str]] = [[] for _ in range(ndim)]
    for axis, pl in zip(layout.mesh.mesh_dim_names, layout.placements):
        if isinstance(pl, Shard):
            per_dim[pl.dim].append(axis)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in per_dim)


def _paths(tree: Any, prefix: str = "") -> list[str]:
    """Leaf paths ``a/b/c`` in :func:`tree_leaves` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, node in enumerate(tree) for p in _paths(node, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _map_with_path(fn, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(p, x) for p, x in zip(_paths(tree), tree_leaves(tree))])


def param_shardings(params_shape: Any, mesh: DeviceMesh, policy: ShardingPolicy = ShardingPolicy()) -> Any:
    """Tree of :class:`Layout` matching a params tree (meta tensors will do)."""
    rules = _rules(policy)
    return _map_with_path(lambda path, leaf: layout_for(mesh, _spec_for(path, leaf.ndim, rules)), params_shape)


def batch_shardings(mesh: DeviceMesh, batch_shape: Any) -> Any:
    """Batch dims shard over (pod, data); everything else replicated."""
    dp = data_axes(mesh)

    def one(leaf):
        if leaf.ndim == 0:
            return layout_for(mesh, ())
        return layout_for(mesh, (dp,) + (None,) * (leaf.ndim - 1))

    return tree_unflatten(batch_shape, [one(x) for x in tree_leaves(batch_shape)])


def cache_shardings(
    cache_shape: Any,
    mesh: DeviceMesh,
    batch: int,
    policy: ShardingPolicy = ShardingPolicy(),
) -> Any:
    """Decode-cache layouts.

    KV leaves are (..., B, S, KV, D); SSM states (..., B, H, P, N); conv
    states (..., B, K, conv).  Batch shards over (pod, data) when divisible;
    batch=1 long-context cells shard the KV sequence axis instead (SP).
    """
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    batch_ok = batch % dp_size == 0 and batch >= dp_size
    m = policy.m()
    m_size = sizes.get("model", 1)

    def ax(axis, dim):
        """``axis`` only if it divides the dimension evenly."""
        if axis is None:
            return None
        size = m_size if axis == "model" else dp_size
        return axis if dim % size == 0 and dim >= size else None

    def one(path, leaf):
        name = path.split("/")[-1]
        nd = leaf.ndim
        shp = leaf.shape
        if name in ("k", "v"):
            _, S, KV, D = shp[-4:]
            head_ax = ax(m, KV)
            seq_ax = ax(m, S) if head_ax is None else None
            if batch_ok:
                trailing = (dp, seq_ax, head_ax, None)
            elif policy.seq_shard_batch1:
                trailing = (None, ax("data", S), head_ax, None)  # SP cache
            else:
                trailing = (None, seq_ax, head_ax, None)
        elif name == "ssm":
            _, H, _, _ = shp[-4:]
            trailing = (dp if batch_ok else None, ax(m, H), None, None)
        elif name == "conv":
            _, _, C = shp[-3:]
            trailing = (dp if batch_ok else None, None, ax(m, C))
        else:
            trailing = (None,) * nd
        return layout_for(mesh, (None,) * (nd - len(trailing)) + tuple(trailing))

    return _map_with_path(one, cache_shape)
