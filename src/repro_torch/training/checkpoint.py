"""Checkpoint and restore in the reference's on-disk format.

Layout per checkpoint::

    <dir>/step_000123/
        manifest.json     # step, leaf count, shapes and dtypes, extra
        arrays/<idx>.npy  # one file per leaf, in jax.tree_util's leaf order

* **Atomicity**: written to ``step_N.tmp`` and renamed; a crash mid-save
  never corrupts the latest checkpoint (rename is atomic on POSIX).
* **Retention**: the ``keep`` newest checkpoints are kept.
* **Interchange**: leaves are numbered in ``jax.tree_util``'s order (dict
  keys sorted; the optimizer state as ``(step, mu, nu)``), so a
  checkpoint written by ``repro.training.checkpoint`` restores into the
  port.  numpy has no bfloat16 of its own: the reference's bf16 leaves are
  stored as 2-byte void records and the port writes ``uint16``; both are
  read through a ``uint16`` view, with the dtype taken from the manifest.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.training.tree import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype))


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: Any,
    *,
    extra: dict | None = None,
    keep: int = 3,
) -> Path:
    """Write ``state`` (nested dicts / tuples of tensors) atomically;
    returns the final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    leaves = tree_leaves(state)
    meta = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / "arrays" / f"{i}.npy", arr)
        meta.append({"shape": list(arr.shape), "dtype": dtype})
    manifest = {
        "step": step,
        "layout": "global-v1",
        "n_leaves": len(leaves),
        "treedef": "repro_torch: jax.tree_util leaf order",
        "leaves": meta,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    kept = sorted(directory.glob("step_*"))
    for old in kept[:-keep]:
        if old.is_dir() and not old.name.endswith(".tmp"):
            shutil.rmtree(old)
    return final


def _shard_of(arr: np.ndarray, dtype: str, ref: torch.Tensor, layout: Any) -> torch.Tensor:
    """This rank's shard of a stored global array, as a DTensor of
    ``layout`` on the mesh's device type."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(tuple(arr.shape), layout.mesh, list(layout.placements))
    index = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    dev = "cpu" if layout.mesh.device_type == "cpu" else torch.device(layout.mesh.device_type, torch.cuda.current_device())
    # np.array copies: the shard must not share the read-only mapping
    local = _from_numpy(np.array(arr[index]), dtype).to(device=dev, dtype=ref.dtype)
    return DTensor.from_local(local, layout.mesh, layout.placements, run_check=False,
                              shape=tuple(arr.shape), stride=torch.empty(arr.shape, device="meta").stride())


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    steps = sorted(
        int(p.name.split("_")[1])
        for p in directory.glob("step_*")
        if p.is_dir() and not p.name.endswith(".tmp")
    )
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str | Path, like: Any, *, step: int | None = None, placements: Any | None = None
) -> tuple[Any, dict]:
    """Restore onto the structure of ``like``: each leaf takes the dtype
    and device of ``like``'s leaf.  Returns (tree, extra | {"step"}).

    ``placements``: optional tree of
    :class:`repro_torch.launch.sharding.Layout` for the TARGET mesh — the
    elastic-resharding path: each leaf comes back as a DTensor of its
    layout, and each rank reads only its shard of the stored global array
    (the files are memory-mapped; every leaf is a writable copy of what was
    read)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_like = tree_leaves(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target tree has "
            f"{len(leaves_like)} — architecture mismatch"
        )
    layouts = tree_leaves(placements) if placements is not None else [None] * len(leaves_like)
    out = []
    for i, (ref, meta, lay) in enumerate(zip(leaves_like, manifest["leaves"], layouts)):
        arr = np.load(path / "arrays" / f"{i}.npy", mmap_mode="r")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: stored {arr.shape} != target {tuple(ref.shape)}")
        if lay is None:
            # a copy: the optimizer writes the restored leaves in place
            out.append(_from_numpy(np.array(arr), meta["dtype"]).to(device=ref.device, dtype=ref.dtype))
        else:
            out.append(_shard_of(arr, meta["dtype"], ref, lay))
    return tree_unflatten(like, out), manifest["extra"] | {"step": manifest["step"]}
