"""Serving driver: waves of batched greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 4096 --tokens 32 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu --batch 2 --prompt-len 24 --tokens 4 --requests 3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --batch 4 --prompt-len 2048 --tokens 16 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \\
        --batch 4 --prompt-len 1024 --src-len 1500 --tokens 16 --requests 4

``--arch`` takes every configuration of ``repro_torch.configs.ARCHS``:
the dense decoders (qwen3-1.7b, h2o-danube-1.8b with its 4096-token
sliding window as a ring cache, yi-9b, phi3-medium-14b), the moe
granite-moe-3b-a800m and qwen2-moe-a2.7b, the ssm mamba2-2.7b, the hybrid
zamba2-7b, the vlm internvl2-76b (141 GB of bf16 weights: more than one
card holds at full depth) and the encdec seamless-m4t-medium.

Random weights from ``--seed``; requests of random tokens from the same
seed.  The frontend stubs are drawn as the reference draws them, standard
normal, from a torch generator on the device seeded with ``--seed``: vlm
requests carry ``frontend_tokens`` patch embeddings each (prepended, so
decode starts at ``prompt + frontend_tokens``), encdec requests
``--src-len`` frame embeddings (default: the prompt length, as the
reference).  Each wave of ``--batch`` prompts runs one batched prefill (the
last wave is padded with its last prompt), then ``--tokens - 1`` greedy
decode steps against the cache.  Runs on the card unless ``--device``
names another.  Prints prefill milliseconds per wave, decode tokens/s and
the kernel launch counts per prefill and per decode step.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, ModelConfig, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
from repro_torch.models.layers import require_ieee_f32
from repro_torch.models.transformer import init_model
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step

__all__ = ["frontend_inputs", "serve", "main"]


def _launches() -> tuple[int, int]:
    return flash_attention_cuda.launches, ssd_intra_chunk_cuda.launches


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frontend_inputs(cfg: ModelConfig, requests: int, src_len: int, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor | None:
    """The frontend stub's embeddings of ``requests`` requests, standard
    normal f32 from ``generator``: vlm (R, frontend_tokens, frontend_dim)
    patches, encdec (R, src_len, frontend_dim) frames, else ``None``."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.frontend_tokens if cfg.family == "vlm" else src_len
    return torch.randn((requests, n, cfg.frontend_dim), generator=generator, device=device)


@torch.no_grad()
def serve(
    params: dict, cfg: ModelConfig, prompts: np.ndarray, *, batch: int, tokens: int,
    device: torch.device, frontend: torch.Tensor | None = None,
) -> dict:
    """Serve ``prompts`` (R, S) in waves of ``batch``; ``tokens`` greedy
    tokens per request (the first from the prefill).  ``frontend``: the
    requests' vlm patch or encdec frame embeddings (R, ...), as
    :func:`frontend_inputs` draws them.  Runs without autograd, so params
    that require grad build no graph.

    Returns the generated ``sequences`` (R, tokens) as numpy, per-wave
    ``prefill_ms`` / ``decode_ms`` (host clock around synchronised work),
    ``prefill_launches`` and ``decode_launches`` per wave as (flash, ssd)
    pairs, decode and end-to-end tokens/s, and ``finite`` (every logit of
    the run was finite)."""
    R, S = prompts.shape
    pos0 = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)   # the prompt's positions
    max_len = pos0 + tokens + 8
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)
    finite = torch.ones((), dtype=torch.bool, device=device)
    out: dict = {"prefill_ms": [], "decode_ms": [], "prefill_launches": [], "decode_launches": []}
    sequences, decoded = [], 0
    _synchronize(device)
    t_start = time.perf_counter()
    for w0 in range(0, R, batch):
        wave = prompts[w0 : w0 + batch]
        padded = np.concatenate([wave, np.repeat(wave[-1:], batch - len(wave), axis=0)])
        toks = torch.as_tensor(padded, dtype=torch.long, device=device)
        fe = None
        if frontend is not None:
            fe = frontend[w0 : w0 + batch]
            fe = torch.cat([fe, fe[-1:].expand(batch - len(fe), *fe.shape[1:])])
        before = _launches()
        t0 = time.perf_counter()
        tok, logits, cache = prefill(params, toks, fe)
        _synchronize(device)
        t1 = time.perf_counter()
        mid = _launches()
        finite &= torch.isfinite(logits).all()
        tok = tok[:, None]
        outs = [tok]
        for step in range(tokens - 1):
            tok, logits, cache = decode(params, tok.long(), cache, pos0 + step)
            finite &= torch.isfinite(logits).all()
            outs.append(tok)
        _synchronize(device)
        t2 = time.perf_counter()
        after = _launches()
        out["prefill_ms"].append((t1 - t0) * 1e3)
        out["decode_ms"].append((t2 - t1) * 1e3)
        out["prefill_launches"].append((mid[0] - before[0], mid[1] - before[1]))
        out["decode_launches"].append((after[0] - mid[0], after[1] - mid[1]))
        sequences.append(torch.cat(outs, dim=1)[: len(wave)].cpu().numpy())
        decoded += len(wave) * tokens
        del cache
    total_s = time.perf_counter() - t_start
    decode_s = sum(out["decode_ms"]) / 1e3
    out["sequences"] = np.concatenate(sequences)
    out["decode_tok_s"] = R * (tokens - 1) / decode_s if tokens > 1 else 0.0
    out["e2e_tok_s"] = decoded / total_s
    out["finite"] = bool(finite)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="the narrow same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8, help="total request count")
    ap.add_argument("--src-len", type=int, default=None,
                    help="encdec source frames per request (default: the prompt length)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    dev = resolve_device(args.device)
    require_ieee_f32()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    frontend = frontend_inputs(cfg, args.requests, args.src_len or args.prompt_len, gen, dev)
    print(f"[serve] {cfg.name} on {dev}: {cfg.param_count():,} parameters ({cfg.dtype})", flush=True)
    res = serve(params, cfg, prompts, batch=args.batch, tokens=args.tokens, device=dev, frontend=frontend)
    for i, (p_ms, d_ms) in enumerate(zip(res["prefill_ms"], res["decode_ms"])):
        print(f"[serve] wave {i}: prefill {p_ms:.1f} ms, {args.tokens - 1} decode steps {d_ms:.1f} ms, "
              f"launches per prefill (flash, ssd) {res['prefill_launches'][i]}, "
              f"in decode {res['decode_launches'][i]}", flush=True)
    print(f"[serve] {args.requests} requests x {args.tokens} tokens: decode "
          f"{res['decode_tok_s']:.1f} tok/s, end to end {res['e2e_tok_s']:.1f} tok/s, "
          f"logits finite: {res['finite']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
