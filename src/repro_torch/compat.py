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
  placements), :func:`distribute` (a tree of tensors placed as DTensors)
  and :func:`run_on_shards` (a kernel on each rank's shards).  They stand
  where the reference's models call ``jax.lax.with_sharding_constraint``
  and leave the rest to GSPMD; the sharding rules that choose the layouts
  are :mod:`repro_torch.launch.sharding`'s.

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

__all__ = ["get_abstract_mesh", "set_mesh", "make_mesh", "Layout", "layout_for", "distribute", "run_on_shards"]

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


def _local_shape(shape: tuple[int, ...], layout: Layout) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor under ``layout``
    (DTensor's uneven split: the leading shards take the remainder)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(tuple(shape), layout.mesh, list(layout.placements))[0])


def distribute(tree: Any, layouts: Any, *, device: str | torch.device | None = None) -> Any:
    """Each leaf as a DTensor of its layout.  A leaf on ``meta`` (or any leaf
    when ``device="meta"``) becomes a DTensor over a meta shard of the local
    shape, so nothing is allocated; other leaves are sliced to this rank's
    shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(x: torch.Tensor, lay: Layout) -> DTensor:
        if device == "meta" or x.device.type == "meta":
            local = torch.empty(_local_shape(tuple(x.shape), lay), dtype=x.dtype, device="meta")
            return DTensor.from_local(local, lay.mesh, lay.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return distribute_tensor(x, lay.mesh, lay.placements, src_data_rank=None)

    return tree_unflatten(tree, [one(x, lay) for x, lay in zip(tree_leaves(tree), tree_leaves(layouts))])


def run_on_shards(fn, tensors: tuple, keep: tuple[int, ...], **kwargs: Any):
    """``fn(*local tensors, **kwargs)`` on each rank's shards of DTensors.

    Every tensor is first laid out alike: a mesh dim keeps the first
    tensor's ``Shard(d)`` when ``d`` is in ``keep`` and the extent divides
    dim ``d`` of every tensor, and replicates otherwise.  ``fn`` then runs
    on the local shards — the kernel a rank launches on its part of the
    batch and heads — and its tensor result is wrapped back with the same
    layout (so the result's sharded dims must be the inputs')."""
    first = tensors[0]
    mesh = first.device_mesh
    placements = []
    for i, pl in enumerate(first.placements):
        ok = (isinstance(pl, Shard) and pl.dim in keep
              and all(t.shape[pl.dim] % mesh.size(i) == 0 for t in tensors))
        placements.append(pl if ok else Replicate())
    local = [t.redistribute(mesh, placements).to_local() for t in tensors]
    out = fn(*local, **kwargs)
    wrap = lambda o: DTensor.from_local(o, mesh, placements, run_check=False)  # noqa: E731
    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)
