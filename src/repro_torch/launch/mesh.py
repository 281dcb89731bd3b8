"""Mesh construction, the port of ``repro.launch.mesh``.

Meshes are :class:`torch.distributed.device_mesh.DeviceMesh` objects over
the default process group, with the reference's axis names: ``model`` the
tensor-parallel axis, ``data`` the FSDP and data-parallel axis, ``pod``
the outer axis that carries only gradient all-reduces.

**The production mesh on H100s** keeps the reference's world sizes (256
and 512 ranks) but not its split.  The reference's ``model`` axis of 16
was one TPU pod's ICI ring.  On H100s tensor parallelism has to stay
inside one host's NVLink domain of 8 cards (450 GB/s each way to the other
cards of the host); across hosts a card has its network port.  So the
single-pod mesh is ``(data=32, model=8)`` and the multi-pod one
``(pod=2, data=32, model=8)``: ``model`` never leaves a host, ``data`` and
``pod`` cross hosts.

A mesh needs a process group.  :func:`make_host_mesh` on one rank sets up a
world-1 group when none exists (gloo on the host, NCCL on the card, through
an in-process store).  :func:`make_production_mesh` does not: without an
initialised group of its world size it raises, as the reference's does
without 512 devices.  The dry run (:mod:`repro_torch.launch.dryrun`)
creates that group with torch's fake backend, in a process of its own.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import compat
from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "data_axes", "data_extent", "axis_sizes", "data_group"]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {dict(zip(axes, shape))}, have {have} — "
            "initialise a process group of that size (launch/dryrun.py makes a fake one)"
        )
    return compat.make_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """32x8 single-pod (256 H100s) or 2x32x8 multi-pod (512 H100s) mesh."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str | torch.device | None = None) -> DeviceMesh:
    """A small ``(data, model)`` mesh over the ranks of the default group.

    On one rank with no group yet, a world-1 group is set up first on
    ``device`` (the card unless the caller names another): NCCL on the
    card, gloo on the host."""
    if not dist.is_initialized() and data * model == 1:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1
        )
    return _mesh((data, model), ("data", "model"))


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis name: extent}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension (pure DP + FSDP axes)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def data_extent(mesh: DeviceMesh) -> int:
    """Total rank count along the batch-carrying axes — the multiple a
    data-parallel batch must pad to (used by the FPCA serving handles)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def data_group(mesh: DeviceMesh) -> tuple[dist.ProcessGroup, int]:
    """The process group over the mesh's data axes and this rank's index in
    it (the data axes flattened in mesh order when there are several)."""
    axes = data_axes(mesh)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    return sub.get_group(), sub.get_local_rank()
