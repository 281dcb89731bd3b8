"""Training entry point: a resumable, checkpointed loop on synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 4 --global-batch 8 --seq-len 4096 --n-micro 2 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 3 --global-batch 4 --seq-len 32 --ckpt-dir /tmp/ckpt

The port of ``repro.launch.train``, with the same flags plus ``--device``
(the CUDA card unless it names another); ``--arch`` takes every
configuration of ``repro_torch.configs.ARCHS``.  Random weights from
``--seed``.  vlm and encdec batches carry the frontend stub's embeddings
(:func:`frontend_batch`); a vlm step's ``--seq-len`` counts the
``frontend_tokens`` patches, as the reference's does.
* checkpoints every ``--ckpt-every`` steps (atomic rename, retention 3) and
  at the end;
* SIGTERM/SIGINT: a final checkpoint and a clean exit 0;
* on start, resumes from the latest checkpoint in ``--ckpt-dir`` (params,
  optimizer moments and step; the data stream is addressed by step), so
  training continues bit-exactly;
* the data pipeline prefetches on a worker thread with a stall deadline.
Prints each logged step's loss, grad_norm, lr, ms/step and tokens/s.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.data.pipeline import LMStreamConfig, PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.layers import require_ieee_f32
from repro_torch.models.transformer import init_model
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_step import make_train_step

__all__ = ["frontend_batch", "main"]


def frontend_batch(cfg, batch: int, seq_len: int, seed: int, step: int) -> torch.Tensor | None:
    """A step's frontend stub, standard normal f32 on the host from a torch
    generator seeded by (``seed``, ``step``), so a resumed run draws the
    same: vlm (batch, frontend_tokens, frontend_dim) patches, encdec
    (batch, seq_len, frontend_dim) frames, else ``None``."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.frontend_tokens if cfg.family == "vlm" else seq_len
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return torch.randn((batch, n, cfg.frontend_dim), generator=gen)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    dev = resolve_device(args.device)
    require_ieee_f32()
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = init_adamw(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro, remat=args.remat)

    start_step = 0
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, opt_state), extra = restore_checkpoint(ckpt_dir, (params, opt_state))
        start_step = int(extra["step"])
        print(f"[train] resumed from step {start_step}", flush=True)

    # vlm: the patches take frontend_tokens of the sequence, the text the rest
    text_len = args.seq_len - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    stream = SyntheticLM(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=text_len,
                                        global_batch=args.global_batch, seed=args.seed))

    def make_batch(step: int) -> dict:
        batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long) for k, v in stream.batch_at(step).items()}
        fe = frontend_batch(cfg, args.global_batch, args.seq_len, args.seed, step)
        if fe is not None:
            batch["frontend"] = fe
        return batch

    prefetch = PrefetchIterator(make_batch, start_step=start_step, timeout_s=120.0)

    stop = {"signal": None}

    def _graceful(signum, frame):  # noqa: ARG001
        # only a flag: a print here, landing inside the loop's own print,
        # raised "reentrant call" on stdout and killed the run
        stop["signal"] = signum

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    def checkpoint(step: int) -> None:
        if ckpt_dir:
            save_checkpoint(ckpt_dir, step, (params, opt_state), extra={"arch": cfg.name, "seed": args.seed})

    print(f"[train] {cfg.name} on {dev}: {cfg.param_count():,} parameters ({cfg.dtype}), "
          f"{args.global_batch} x {args.seq_len} tokens per step, n_micro {args.n_micro}, "
          f"remat {args.remat}", flush=True)
    losses = []
    step = start_step
    try:
        while step < args.steps and stop["signal"] is None:
            got_step, batch = next(prefetch)
            assert got_step == step, f"pipeline cursor mismatch {got_step} != {step}"
            batch = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))   # synchronises with the card
            dt = time.perf_counter() - t0
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                print(
                    f"[train] step {step:5d} loss {losses[-1]:.4f} "
                    f"grad_norm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                    f"{dt * 1e3:.0f} ms/step {args.global_batch * args.seq_len / dt:.0f} tokens/s",
                    flush=True,
                )
            if step % args.ckpt_every == 0:
                checkpoint(step)
    finally:
        prefetch.close()
    if stop["signal"] is not None:
        print(f"[train] signal {stop['signal']}: checkpointing and exiting", flush=True)
    checkpoint(step)
    if len(losses) >= 20:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"[train] loss {first:.4f} -> {last:.4f} over {step - start_step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
