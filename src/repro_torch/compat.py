"""The ambient device mesh and mesh construction, the port of
``repro.compat``.

The reference's module bridges jax versions; the port has one torch, so
what is left is the role the rest of the code relies on:

* :func:`set_mesh` — context manager installing an ambient
  :class:`~torch.distributed.device_mesh.DeviceMesh`;
* :func:`get_abstract_mesh` — the installed mesh, or ``None`` when none is
  installed (the models' :func:`repro_torch.models.layers.maybe_shard` is
  the identity then);
* :func:`make_mesh` — ``init_device_mesh`` over the default process group
  with named axes;
* the DTensor helpers the models use under a mesh: :class:`Layout` and
  :func:`layout_for` (a ``PartitionSpec``-shaped tuple of axis names as
  placements), :func:`distribute` (a tree of tensors placed as DTensors),
  and the pieces of per-shard code: :func:`box` / :func:`span` (a rank's
  part of a layout), :func:`local` and :func:`wrap` (a DTensor's shard in
  a chosen layout and back), :func:`reduce_over` (a sum or max over mesh
  dims) and :func:`write_into` / :func:`assign` (in-place writes into a
  cache's shards).  They stand where the reference's models call
  ``jax.lax.with_sharding_constraint`` and leave the rest to GSPMD; the
  sharding rules that choose the layouts are
  :mod:`repro_torch.launch.sharding`'s.  The models run their attention,
  MoE routing and Mamba2 heads as plain torch code on each rank's shards
  through these helpers: only layout changes and collectives are left to
  DTensor, whose op strategies differ from one torch release to the next;
* the padded batch of a train or prefill step: :func:`padded_rows`,
  :func:`pad_rows` / :func:`unpad_rows` and :func:`real_row_mask` (a batch
  that does not divide the data axes, padded to them as the reference's
  GSPMD pads it).

``cost_analysis_dict`` has no torch counterpart: it normalised XLA's
``Compiled.cost_analysis()``, and eager torch compiles nothing to ask.  The
port counts a step's FLOPs, bytes and collectives by running it under
:func:`repro_torch.launch.step_analysis.analyze_step`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.training.tree import tree_leaves, tree_unflatten

__all__ = ["get_abstract_mesh", "set_mesh", "make_mesh", "Layout", "layout_for", "distribute", "batch_placements",
           "padded_rows", "pad_rows", "unpad_rows", "real_row_mask", "box", "span", "local", "wrap", "reduce_over",
           "for_heads", "write_into", "assign"]

_ambient = threading.local()


def get_abstract_mesh() -> DeviceMesh | None:
    """The mesh installed by the innermost :func:`set_mesh`, or ``None``."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Install ``mesh`` as the ambient mesh for in-step sharding
    constraints."""
    stack = _ambient.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _device_type() -> str:
    """The device type the default process group's meshes live on:
    ``"cuda"`` under NCCL, ``"cpu"`` under gloo or the fake backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the default group."""
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


@dataclasses.dataclass(frozen=True)
class Layout:
    """One leaf's layout: the mesh and a placement per mesh dim."""

    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def layout_for(mesh: DeviceMesh, spec: tuple) -> Layout:
    """The placements of a ``PartitionSpec``-shaped tuple: entry ``i`` names
    the mesh axis (or a tuple of axes, in mesh order) sharding tensor dim
    ``i``."""
    owner: dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            if axis in owner:
                raise ValueError(f"mesh axis {axis!r} used twice in {spec}")
            owner[axis] = dim
    unknown = set(owner) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not in mesh {mesh.mesh_dim_names}")
    return Layout(mesh, tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names))


def distribute(tree: Any, layouts: Any, *, device: str | torch.device | None = None) -> Any:
    """Each leaf as a DTensor of its layout.  A leaf on ``meta`` (or any leaf
    when ``device="meta"``) becomes a DTensor over a meta shard of the local
    shape, so nothing is allocated; other leaves are sliced to this rank's
    shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(x: torch.Tensor, lay: Layout) -> DTensor:
        if device == "meta" or x.device.type == "meta":
            local = torch.empty(box(x.shape, lay.mesh, lay.placements)[0], dtype=x.dtype, device="meta")
            return DTensor.from_local(local, lay.mesh, lay.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return distribute_tensor(x, lay.mesh, lay.placements, src_data_rank=None)

    return tree_unflatten(tree, [one(x, lay) for x, lay in zip(tree_leaves(tree), tree_leaves(layouts))])


def batch_placements(mesh: DeviceMesh, n: int) -> list[Placement]:
    """Placements of a batch of ``n`` rows: ``Shard(0)`` over the leading
    data axes (``pod``, ``data``, in mesh order) whose extents' product
    divides ``n``, replicated over the rest.  A train or prefill batch
    divides them all, padded to the data extent when it did not
    (:func:`pad_rows`, as the reference's GSPMD pads it), so it shards over
    every data axis; a decode batch that divides neither replicates over the
    axes it does not divide (DTensor's view of an uneven shard fails in
    every matmul)."""
    out, ext, stopped = [], 1, False
    for a, size in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data") and not stopped and n % (ext * size) == 0:
            out.append(Shard(0))
            ext *= size
        else:
            stopped |= a in ("pod", "data")
            out.append(Replicate())
    return out


def _data_dims(mesh: DeviceMesh) -> list[int]:
    return [i for i, a in enumerate(mesh.mesh_dim_names) if a in ("pod", "data")]


def padded_rows(mesh: DeviceMesh, n: int) -> int:
    """``n`` rows rounded up to a multiple of the data extent (the product
    of the ``pod`` and ``data`` axes)."""
    ext = math.prod(mesh.shape[i] for i in _data_dims(mesh))
    return -(-n // ext) * ext


def _rows_layout(x: DTensor, dim: int) -> list[Placement]:
    """``x``'s placements with tensor dim ``dim`` sharded over every data
    axis (and over no other)."""
    data = _data_dims(x.device_mesh)
    return [Shard(dim) if i in data else Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim else p
            for i, p in enumerate(x.placements)]


def pad_rows(x: DTensor, n_pad: int, dim: int = 0) -> DTensor:
    """``x``'s rows along tensor dim ``dim`` padded to ``n_pad`` (a multiple
    of the data extent, :func:`padded_rows`) and sharded evenly over every
    data axis.  Each rank's block holds its share of the real rows as
    DTensor's uneven split lays them out (the leading ranks take the
    remainder), then zero rows: no row moves between ranks, and
    :func:`unpad_rows` is the inverse.  The real rows keep their order."""
    pl = _rows_layout(x, dim)
    t = local(x, pl)
    shape = list(x.shape)
    shape[dim] = n_pad
    per = box(shape, x.device_mesh, pl)[0][dim]
    fill = list(t.shape)
    fill[dim] = per - t.shape[dim]
    return wrap(torch.cat([t, t.new_zeros(fill)], dim), x.device_mesh, pl, shape)


def unpad_rows(x: DTensor, n: int, dim: int = 0) -> DTensor:
    """The ``n`` real rows of a :func:`pad_rows` batch, each rank keeping
    its own: a DTensor of ``n`` rows along ``dim`` in DTensor's uneven split
    over the data axes."""
    pl = _rows_layout(x, dim)
    shape = list(x.shape)
    shape[dim] = n
    keep = box(shape, x.device_mesh, pl)[0][dim]
    return wrap(local(x, pl).narrow(dim, 0, keep), x.device_mesh, pl, shape)


def real_row_mask(mesh: DeviceMesh, n: int, n_pad: int, device: str | torch.device | None = None) -> torch.Tensor:
    """(n_pad,) bool: the rows of a :func:`pad_rows` batch that hold real
    rows, in the padded order (every rank's block in turn).  A block's real
    count is its share of DTensor's uneven split of ``n``, applied over the
    data axes in mesh order: each split is ``torch.chunk``'s."""
    counts = [n]
    for i in _data_dims(mesh):
        s = mesh.shape[i]
        counts = [max(0, min(-(-c // s), c - j * -(-c // s))) for c in counts for j in range(s)]
    per = n_pad // len(counts)
    return (torch.arange(per, device=device)[None, :] < torch.tensor(counts, device=device)[:, None]).reshape(-1)


def box(shape, mesh: DeviceMesh, placements) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of a ``shape``
    tensor laid out as ``placements`` (DTensor's uneven split: the leading
    shards take the remainder)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, list(placements))
    return tuple(shape), tuple(offset)


def span(x: DTensor, dim: int, placements=None) -> tuple[int, int]:
    """(offset, length) of this rank's part of tensor dim ``dim`` of ``x``
    laid out as ``placements`` (``x``'s own by default)."""
    shape, offset = box(x.shape, x.device_mesh, x.placements if placements is None else placements)
    dim %= x.ndim
    return offset[dim], shape[dim]


def local(x: DTensor, placements, grad=None) -> torch.Tensor:
    """This rank's shard of ``x`` laid out as ``placements``.  ``grad``
    names the gradient's placements where they differ from the forward's:
    ``Partial()`` on a mesh dim whose ranks each use a different part of a
    gathered tensor (their gradients are summed on the way back)."""
    y = x.redistribute(x.device_mesh, tuple(placements))
    return y.to_local(grad_placements=None if grad is None else tuple(grad))


def wrap(t: torch.Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    """The local ``t`` as a DTensor of global ``shape`` laid out as
    ``placements`` (uneven shards included), made contiguous: the global
    strides are a contiguous tensor's.  Where ``placements`` hold a
    ``Partial`` the gradient comes back replicated, each rank's the
    result's (torch 2.11 keeps a replicated gradient as it is; later
    releases normalise the forward's ``Partial`` to ``Replicate``)."""
    shape = torch.Size(shape)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements), run_check=False, shape=shape, stride=stride)


def reduce_over(t: torch.Tensor, mesh: DeviceMesh, dims, op: str = "sum", *, own: bool = False) -> torch.Tensor:
    """The ``op`` ("sum" or "max") of the local ``t`` over the ranks of mesh
    dims ``dims``, as a local tensor on each of them.  For "sum" the
    gradient of ``t`` is the result's where every rank uses the result
    alike, and the sum of the ranks' result gradients where each uses it
    for its own part (``own``: a norm over heads split across ranks)."""
    from torch.distributed.tensor import Partial

    dims = set(dims)
    if not dims:
        return t
    part = [Partial(op) if i in dims else Replicate() for i in range(mesh.ndim)]
    full = [Replicate()] * mesh.ndim
    return local(wrap(t, mesh, part, t.shape), full, part if own else None)


def for_heads(t: torch.Tensor, dim: int, h0: int, hl: int, per: int) -> torch.Tensor:
    """The groups along tensor dim ``dim`` of ``t`` that global heads
    ``[h0, h0 + hl)`` read, head h reading group ``h // per`` (GQA's KV
    heads, Mamba2's B / C groups): a slice where the heads fall in whole
    groups or all in one, else one group per head (an expand, whose
    gradient is a plain sum)."""
    lo, hi = h0 // per, -(-(h0 + hl) // per)
    t = t.narrow(dim, lo, max(hi - lo, 0))
    if hl == 0 or hi - lo == 1 or (h0 % per == 0 and hl % per == 0):
        return t
    shape = list(t.shape)
    each = t.unsqueeze(dim + 1).expand(*shape[: dim + 1], per, *shape[dim + 1 :]).flatten(dim, dim + 1)
    return each.narrow(dim, h0 - lo * per, hl)


def write_into(dst: DTensor, src: torch.Tensor, dim: int, start: int = 0, rows: int | None = None) -> None:
    """``dst[..., start : start + n, ...] = src`` along tensor dim ``dim``
    (``n`` is ``src``'s extent there), in place on each rank's shard of
    ``dst``.  ``rows``: ``src`` is a :func:`pad_rows` batch (tensor dim 0)
    of that many real rows, and ``dst`` takes the real rows.  Where ``dst``
    shards ``dim`` over the innermost data axis and its rows over none (a
    sequence-parallel cache) the rows move by an all-to-all
    (:func:`_exchange_rows`); otherwise ``src`` is laid out as ``dst`` but
    whole along ``dim``, and each rank copies the part that falls in its own
    range.  A plain ``src`` is the same on every rank."""
    mesh = dst.device_mesh
    dim %= dst.ndim
    o, n = span(dst, dim)
    if isinstance(src, DTensor) and _sequence_parallel(dst, src, dim):
        src_l = _exchange_rows(dst, src, dim, start, rows)
        lo = max(start, o)
        if src_l.shape[dim]:
            dst._local_tensor.narrow(dim, lo - o, src_l.shape[dim]).copy_(src_l)
        return
    if rows is not None:
        src = unpad_rows(src, rows)
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = wrap(src, mesh, [Replicate()] * mesh.ndim, src.shape)
    src_l = local(src, pl)
    lo, hi = max(start, o), min(start + src_l.shape[dim], o + n)
    if hi > lo:
        dst._local_tensor.narrow(dim, lo - o, hi - lo).copy_(src_l.narrow(dim, lo - start, hi - lo))


def _sequence_parallel(dst: DTensor, src: DTensor, dim: int) -> bool:
    """Whether ``dst`` shards tensor dim ``dim`` over the innermost data
    axis alone and its rows (dim 0) over no data axis, while ``src``'s rows
    split evenly over every data axis."""
    mesh, data = dst.device_mesh, _data_dims(dst.device_mesh)
    if not data or dim == 0 or src.shape[0] % math.prod(mesh.shape[i] for i in data):
        return False
    on_dim = [i for i, p in enumerate(dst.placements) if isinstance(p, Shard) and p.dim == dim]
    return on_dim == [data[-1]] and not any(dst.placements[i] == Shard(0) for i in data)


def _exchange_rows(dst: DTensor, src: DTensor, dim: int, start: int, rows: int | None) -> torch.Tensor:
    """The rows of ``src`` (the real ones of a padded batch) in this rank's
    range of ``dst`` along ``dim``, as ``dst``'s local layout has them.
    Each rank holds its rows of ``src``, whole along ``dim``; over the
    innermost data axis an all-to-all sends each rank's rows in every other
    rank's range (the least that has to move: a gather would bring each rank
    all of them), then the outer data axes gather the rows, in the padded
    order, and the real ones are kept."""
    import torch.distributed._functional_collectives as funcol

    mesh, data = dst.device_mesh, _data_dims(dst.device_mesh)
    pl = [Shard(0) if i in data else Replicate() if isinstance(p, Shard) and p.dim in (0, dim) else p
          for i, p in enumerate(dst.placements)]
    src_l = local(src, pl)                                    # (rows of this rank, ..., whole along dim, ...)
    inner, size, extent = data[-1], dst.shape[dim], src.shape[dim]
    chunk = -(-size // mesh.shape[inner])

    def part(k: int) -> torch.Tensor:
        """The rows' part in rank k's range along the inner data axis."""
        lo, hi = max(start, k * chunk), min(start + extent, size, (k + 1) * chunk)
        return src_l.narrow(dim, lo - start if hi > lo else 0, max(hi - lo, 0))

    parts = [part(k) for k in range(mesh.shape[inner])]
    mine = list(parts[mesh.get_local_rank(inner)].shape)
    recv = funcol.all_to_all_single(torch.cat([t.reshape(-1) for t in parts]),
                                    [math.prod(mine)] * len(parts), [t.numel() for t in parts],
                                    mesh.get_group(inner))
    out = recv.view(len(parts) * mine[0], *mine[1:])
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor   # renamed after torch 2.11
    for i in reversed(data[:-1]):
        out = gather(out, 0, mesh.get_group(i))
    if rows is not None:
        keep = real_row_mask(mesh, rows, src.shape[0]).nonzero()[:, 0]
        out = out.index_select(0, keep.to(out.device))
    return out


def assign(dst: DTensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` on each rank's shard of ``dst`` (a view of a cache
    leaf is written in place): ``src`` is laid out as ``dst`` first."""
    if not isinstance(src, DTensor):
        src = wrap(src, dst.device_mesh, [Replicate()] * dst.device_mesh.ndim, src.shape)
    dst._local_tensor.copy_(local(src, dst.placements))
