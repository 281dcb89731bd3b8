"""Cell machinery, the port of ``repro.launch.cells``: (architecture x
input shape x mesh) -> a step and its arguments, then its counts.

:func:`build_cell` builds the port's train, prefill or decode step and its
arguments as meta tensors — DTensors with the layouts of
:mod:`repro_torch.launch.sharding` when the mesh has more than one rank —
so nothing is allocated.  The reference lowers and compiles the jitted
step (``lower_cell``); eager torch has nothing to lower, so
:func:`trace_cell` runs the step once on the meta arguments under the step
counter (:mod:`repro_torch.launch.step_analysis`) and adds the per-rank
bytes of the state the step holds: parameters, gradient accumulators,
AdamW moments and the decode cache, from the local shard shapes.  The
kernels' wrappers route meta tensors to their plain versions, so a traced
cell counts the plain versions' ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import data_axes, data_extent
from repro_torch.launch.roofline import HW, summarize_cell
from repro_torch.launch.sharding import (
    ShardingPolicy,
    batch_shardings,
    cache_shardings,
    distribute,
    layout_for,
    param_shardings,
)
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_step import make_train_step, pick_microbatches
from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["CellPlan", "build_cell", "trace_cell", "meshed"]


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Tunable levers of one cell (the hillclimb knobs)."""

    policy: ShardingPolicy = ShardingPolicy()
    remat: str = "full"
    n_micro: int = 0            # 0 -> auto via pick_microbatches
    donate: bool = True         # the reference's field; eager steps update their state in place
    act_budget_bytes: float = 4e9


def _batch_geometry(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Token/frontend layout for one shape; vlm reserves patch positions."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        s_text = S - cfg.frontend_tokens
        return {
            "tokens": (B, s_text),
            "labels": (B, s_text),
            "frontend": (B, cfg.frontend_tokens, cfg.frontend_dim),
        }
    if cfg.family == "encdec":
        return {"tokens": (B, S), "labels": (B, S), "frontend": (B, S, cfg.frontend_dim)}
    return {"tokens": (B, S), "labels": (B, S)}


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _placed(tree: Any, layouts: Any, mesh) -> Any:
    """DTensors of ``layouts`` on a mesh of more than one rank; the plain
    meta tensors on one rank."""
    return distribute(tree, layouts) if mesh.size() > 1 else tree


def build_cell(
    cfg: ModelConfig, shape: ShapeSpec, mesh, plan: CellPlan = CellPlan()
) -> tuple[Any, tuple]:
    """Returns (step, args) for one cell; the args live on ``meta``."""
    params_shape = init_model(cfg, device="meta")
    p_lay = param_shardings(params_shape, mesh, plan.policy)
    params = _placed(params_shape, p_lay, mesh)
    dp = data_extent(mesh)
    B = shape.global_batch

    if shape.kind == "train":
        geo = _batch_geometry(cfg, shape)
        batch_shape = {
            k: _meta(v, torch.int32 if k in ("tokens", "labels") else torch.bfloat16)
            for k, v in geo.items()
        }
        batch = _placed(batch_shape, batch_shardings(mesh, batch_shape), mesh)
        per_dev = max(1, B // dp)
        n_micro = plan.n_micro or pick_microbatches(cfg, per_dev, shape.seq_len, plan.act_budget_bytes)
        moments = tree_map(lambda p: _meta(tuple(p.shape), torch.float32), params_shape)
        # the step counter is a host scalar, as the port's AdamW keeps it
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                         mu=_placed(moments, p_lay, mesh), nu=_placed(moments, p_lay, mesh))
        step = make_train_step(cfg, AdamWConfig(), n_micro=n_micro, remat=plan.remat)
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        geo = _batch_geometry(cfg, shape)
        dp_axes = data_axes(mesh)
        # a batch that does not divide the data axes shards unevenly here;
        # the step pads it to them (models/transformer.py::_pad_batch)
        tokens = _placed(_meta(geo["tokens"], torch.int32), layout_for(mesh, (dp_axes, None)), mesh)
        args = [tokens]
        if "frontend" in geo:
            args.append(_placed(_meta(geo["frontend"], torch.bfloat16),
                                layout_for(mesh, (dp_axes, None, None)), mesh))
        # the cache prefill fills takes the decode cells' layout
        step = make_prefill_step(cfg, max_len=shape.seq_len, remat=plan.remat,
                                 place_cache=lambda c: _placed(c, cache_shardings(c, mesh, B, plan.policy), mesh))
        return step, (params, *args)

    if shape.kind == "decode":
        cache_shape = init_cache(cfg, B, shape.seq_len, device="meta")
        cache = _placed(cache_shape, cache_shardings(cache_shape, mesh, B, plan.policy), mesh)
        tok_spec = (data_axes(mesh), None) if B % dp == 0 and B >= dp else ()
        token = _placed(_meta((B, 1), torch.int32), layout_for(mesh, tok_spec), mesh)
        step = make_decode_step(cfg)
        return step, (params, token, cache, shape.seq_len - 1)

    raise ValueError(shape.kind)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return getattr(x, "_local_tensor", x)


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of a tree of tensors / DTensors."""
    return sum(_local(x).numel() * _local(x).element_size() for x in tree_leaves(tree))


def per_device_bytes(shape: ShapeSpec, args: tuple) -> dict[str, int]:
    """Per-rank bytes of the state a cell's step holds, from the local
    shard shapes of its arguments."""
    params = args[0]
    out = {"params": _local_bytes(params)}
    if shape.kind == "train":
        # the train step's f32 gradient accumulators have the params' layout
        out["grads_f32"] = sum(4 * _local(p).numel() for p in tree_leaves(params))
        out["optimizer"] = _local_bytes((args[1].mu, args[1].nu))
        out["batch"] = _local_bytes(args[2])
    elif shape.kind == "decode":
        out["cache"] = _local_bytes(args[2])
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def meshed(mesh):
    """The context a meshed step runs in: ``mesh`` as the ambient mesh, and
    the plain tensors the step makes (positions, masks, zero accumulators)
    replicated on every rank beside its DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    with compat.set_mesh(mesh), implicit_replication():
        yield mesh


def trace_cell(
    cfg: ModelConfig, shape: ShapeSpec, mesh, plan: CellPlan = CellPlan(), hw: HW = HW()
) -> dict[str, Any]:
    """Build one cell, run its step once on meta under the step counter and
    return its roofline record (:func:`repro_torch.launch.roofline.summarize_cell`)."""
    t0 = time.time()
    step, args = build_cell(cfg, shape, mesh, plan)
    pdb = per_device_bytes(shape, args)
    t_build = time.time() - t0
    t0 = time.time()
    grad = contextlib.nullcontext() if shape.kind == "train" else torch.no_grad()
    with meshed(mesh), grad:
        stats = analyze_step(step, *args, world=mesh.size())
    rec = summarize_cell(stats, cfg, shape, mesh.size(), hw, per_device_bytes=pdb)
    rec.update(build_s=round(t_build, 2), trace_s=round(time.time() - t0, 2))
    return rec

