"""AdamW with global-norm clipping and a warmup + cosine LR schedule.

The port of ``repro.training.optimizer``, written out rather than taken
from ``torch.optim.AdamW``: the reference clips by the global norm first,
adds the weight decay to the Adam direction before the LR multiplies it,
and divides by the bias corrections explicitly, and the port keeps that
order.  Moments are f32 whatever the params' dtype.  Unlike the reference,
which returns new trees, :func:`adamw_update` writes the params and
moments in place (a 1.7 B-parameter model's f32 moments are 14 GB; a copy
per step would be wasted memory) and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "init_adamw", "adamw_update", "make_lr_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar on the host
    mu: Any                # first moments, f32, the params' tree and devices
    nu: Any                # second moments


def init_adamw(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor on
    the leaves' device)."""
    leaves = [x.float() for x in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def make_lr_schedule(cfg: AdamWConfig) -> Callable[[int], float]:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr``, evaluated in
    f32 as the reference does; returns the f32 value as a float."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = s / f32(max(cfg.warmup_steps, 1))
        prog = np.clip((s - f32(cfg.warmup_steps)) / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(cfg.min_lr_ratio) + f32((1 - cfg.min_lr_ratio) * 0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(cfg.lr) * (warm if s < f32(cfg.warmup_steps) else cos))

    return schedule


@torch.no_grad()
def adamw_update(
    grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig
) -> tuple[Any, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, new state, metrics ``grad_norm``,
    ``lr``).  ``params`` and the state's moments are updated in place;
    ``grads`` are read only."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = int(state.step) + 1
    lr = make_lr_schedule(cfg)(step)
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    for g, m, v, p in zip(*(tree_leaves(t) for t in (grads, state.mu, state.nu, params))):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
    return params, AdamWState(torch.tensor(step, dtype=torch.int32), state.mu, state.nu), metrics
