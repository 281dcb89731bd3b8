"""Serving steps: batched prefill and single-token greedy decode."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_decode, forward_prefill, init_cache

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample", "make_empty_cache"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *, max_len: int | None = None, remat: str = "dots"):
    """``prefill_step(params, tokens, frontend_embeds=None) -> (next token
    (B,), logits (B, V), cache)``; ``frontend_embeds`` are the vlm patch or
    encdec frame embeddings (:func:`forward_prefill`).  ``remat`` keeps the
    reference's signature and is ignored: prefill runs without autograd."""

    def prefill_step(params, tokens, frontend_embeds=None):
        logits, cache = forward_prefill(params, cfg, tokens, frontend_embeds=frontend_embeds, max_len=max_len)
        return greedy_sample(logits), logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, token (B,1), cache, pos) -> (next token (B,1),
    logits, cache)``; the cache is updated in place."""

    def decode_step(params, token, cache, pos):
        logits, cache = forward_decode(params, cfg, token, cache, pos)
        return greedy_sample(logits)[:, None], logits, cache

    return decode_step


def make_empty_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> dict:
    return init_cache(cfg, batch, max_len, device=device)
