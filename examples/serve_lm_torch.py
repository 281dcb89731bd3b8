"""Batched LM serving demo, in PyTorch: prefill a batch of prompts, then
greedy-decode.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-1.7b --tokens 32 [--device cpu]

The torch twin of ``examples/serve_lm.py``; runs on the CUDA card unless
``--device`` names another.  Like the original it serves the reduced
(smoke) config of ``--arch``, so it runs on the host in seconds;
``python -m repro_torch.launch.serve --arch <arch>`` serves the published
width and depth.  ``--arch`` takes every configuration: the attention
families launch the flash-attention kernel in every prefill on the card,
the ssm and hybrid ones the SSD kernel.  Weights are drawn from seed 0,
prompts from seed 1 and the vlm patch / encdec frame embeddings from
seed 2, as the original's ``PRNGKey(0)``, ``PRNGKey(1)`` and
``PRNGKey(2)``.  ``main`` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, ModelConfig, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
from repro_torch.models.transformer import init_model
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step


def init_params(cfg: ModelConfig, device: torch.device, seed: int) -> dict:
    return init_model(cfg, generator=torch.Generator(device=device).manual_seed(seed), device=device)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prompt_len))


def make_frontend(cfg: ModelConfig, batch: int, prompt_len: int, device: torch.device,
                  seed: int) -> torch.Tensor | None:
    """The original's frontend stub: vlm patch embeddings (batch,
    frontend_tokens, frontend_dim), encdec frame embeddings (batch,
    prompt_len, frontend_dim), standard normal; ``None`` otherwise."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.frontend_tokens if cfg.family == "vlm" else prompt_len
    return torch.randn((batch, n, cfg.frontend_dim), generator=torch.Generator(device=device).manual_seed(seed),
                       device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_for_smoke(ARCHS[args.arch])
    params = init_params(cfg, dev, 0)
    max_len = args.prompt_len + args.tokens + 8
    prompts = torch.as_tensor(make_prompts(cfg, args.batch, args.prompt_len, 1),
                              dtype=torch.long, device=dev)

    frontend = make_frontend(cfg, args.batch, args.prompt_len, dev, 2)

    prefill = make_prefill_step(cfg, max_len=max_len, remat="none")
    decode = make_decode_step(cfg)
    launches0 = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)

    _sync(dev)
    t0 = time.perf_counter()
    tok, logits, cache = prefill(params, prompts, frontend)
    tok = tok[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    launches1 = (flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches)
    print(f"prefill: {args.batch} x {args.prompt_len} tokens in {t_prefill*1e3:.0f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")

    pos0 = args.prompt_len + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    outputs = [tok]
    t0 = time.perf_counter()
    for step in range(args.tokens - 1):
        tok, logits, cache = decode(params, tok.long(), cache, pos0 + step)
        outputs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    seqs = torch.cat(outputs, dim=1).cpu().numpy()
    print(f"decode: {args.tokens} steps x {args.batch} seqs in {t_decode*1e3:.0f} ms "
          f"({args.batch*args.tokens/t_decode:.0f} tok/s)")
    print(f"first sequence: {seqs[0].tolist()}")
    return {
        "arch": cfg.name,
        "sequences": seqs,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "finite": bool(torch.isfinite(logits).all()),
        "prefill_launches": (launches1[0] - launches0[0], launches1[1] - launches0[1]),
    }


if __name__ == "__main__":
    main()
