"""The train step: gradient accumulation over microbatches, then AdamW.

``make_train_step(cfg, ...)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``, the port of
``repro.training.train_step``: each microbatch's gradients (the params'
dtype) are added into f32 accumulators, averaged, and applied once per
step.  The params are made leaves that require grad on the first call.
A batch is ``tokens``, ``labels``[, ``loss_mask``][, ``frontend``: the vlm
patch or encdec frame embeddings], each split along its batch axis.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_train
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update
from repro_torch.training.tree import tree_leaves, tree_unflatten

__all__ = ["make_train_step", "pick_microbatches"]

METRIC_KEYS = ("ce_loss", "moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def pick_microbatches(
    cfg: ModelConfig, per_device_batch: int, seq_len: int, budget_bytes: float = 4e9
) -> int:
    """Number of accumulation steps so saved per-layer activations fit a
    ~4 GB budget per device (residual-stream carries dominate under remat)."""
    bytes_per_seq_layer = seq_len * cfg.d_model * 2  # bf16 residual carry
    per_seq = bytes_per_seq_layer * max(cfg.n_layers, 1)
    if cfg.family in ("ssm", "hybrid"):
        per_seq *= cfg.ssm_expand  # inner-width carries
    micro_bs = min(max(1, int(budget_bytes // max(per_seq, 1))), per_device_batch)
    # round UP so the budget is respected, then up again to a divisor
    n_micro = -(-per_device_batch // micro_bs)
    while per_device_batch % n_micro:
        n_micro += 1
    return n_micro


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    n_micro: int = 1,
    remat: str = "full",
):
    """The train step, accumulating over ``n_micro`` microbatches."""

    def train_step(
        params: dict, opt_state: AdamWState, batch: dict[str, torch.Tensor]
    ) -> tuple[dict, AdamWState, dict[str, torch.Tensor]]:
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"global batch {b} not divisible by n_micro={n_micro}")
        mb = b // n_micro
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        # the reference's metrics: encdec reports ce_loss alone
        keys = ("ce_loss",) if cfg.family == "encdec" else METRIC_KEYS
        metric_sums = {k: torch.zeros_like(loss_sum) for k in keys}
        for i in range(n_micro):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            loss, metrics = forward_train(params, cfg, micro, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum += loss.detach()
            for k in keys:
                metric_sums[k] += metrics[k].detach()
        torch._foreach_div_(acc, float(n_micro))
        params, opt_state, opt_metrics = adamw_update(tree_unflatten(params, acc), opt_state, params, opt_cfg)
        out = {k: v / n_micro for k, v in metric_sums.items()}
        out.update(opt_metrics)
        out["loss"] = loss_sum / n_micro
        return params, opt_state, out

    return train_step
