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
  DTensor, whose op strategies differ from one torch release to the next.

``cost_analysis_dict`` has no torch counterpart: it normalised XLA's
``Compiled.cost_analysis()``, and eager torch compiles nothing to ask.  The
port counts a step's FLOPs, bytes and collectives by running it under
:func:`repro_torch.launch.step_analysis.analyze_step`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.training.tree import tree_leaves, tree_unflatten

__all__ = ["get_abstract_mesh", "set_mesh", "make_mesh", "Layout", "layout_for", "distribute", "batch_placements",
           "box", "span", "local", "wrap", "reduce_over", "for_heads", "write_into", "assign"]

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
    divides ``n``, replicated over the rest.  A batch never shards unevenly
    (DTensor's view of an uneven shard fails in every matmul); the
    reference's GSPMD pads it instead, e.g. 32 prefill rows on the 64 data
    ranks of the multi-pod mesh shard over ``pod`` alone."""
    out, ext, stopped = [], 1, False
    for a, size in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data") and not stopped and n % (ext * size) == 0:
            out.append(Shard(0))
            ext *= size
        else:
            stopped |= a in ("pod", "data")
            out.append(Replicate())
    return out


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


def write_into(dst: DTensor, src: torch.Tensor, dim: int, start: int = 0) -> None:
    """``dst[..., start : start + n, ...] = src`` along tensor dim ``dim``
    (``n`` is ``src``'s extent there), in place on each rank's shard of
    ``dst``: ``src`` is laid out as ``dst`` but whole along ``dim``, and each
    rank copies the part that falls in its own range.  A plain ``src`` is
    the same on every rank."""
    mesh = dst.device_mesh
    dim %= dst.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = wrap(src, mesh, [Replicate()] * mesh.ndim, src.shape)
    src_l = local(src, pl)
    o, n = span(dst, dim)
    lo, hi = max(start, o), min(start + src_l.shape[dim], o + n)
    if hi > lo:
        dst._local_tensor.narrow(dim, lo - o, hi - lo).copy_(src_l.narrow(dim, lo - start, hi - lo))


def assign(dst: DTensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` on each rank's shard of ``dst`` (a view of a cache
    leaf is written in place): ``src`` is laid out as ``dst`` first."""
    if not isinstance(src, DTensor):
        src = wrap(src, dst.device_mesh, [Replicate()] * dst.device_mesh.ndim, src.shape)
    dst._local_tensor.copy_(local(src, dst.placements))
