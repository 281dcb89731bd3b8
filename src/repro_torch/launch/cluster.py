"""Multi-host cluster launch helper, the port of ``repro.launch.cluster``.

Each host runs the same training entry point under ``torchrun``, one
process per card.  This module (1) joins the job's process group when
torchrun's variables are present, and (2) writes the per-host launch
commands for a (pods x 32 x 8)-card job — the glue a scheduler consumes.

The reference's lines set ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID`` for ``jax.distributed.initialize`` and ``LIBTPU_INIT_ARGS``
for XLA's async collective fusion on TPU.  Neither has a meaning here:
torchrun's rendezvous (``--rdzv-endpoint``) sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` for every
process, and NCCL needs no flag to overlap its collectives.

Fault tolerance at cluster level: every host runs the same resumable loop
(``launch/train.py``); on preemption the job restarts from the latest
checkpoint with a possibly different rank count, and
``training/checkpoint.py``'s ``placements=`` re-lays the state out.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["maybe_init_distributed", "launch_commands"]

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def maybe_init_distributed() -> bool:
    """Join the job's NCCL process group from torchrun's variables, on the
    card ``LOCAL_RANK`` names; ``False`` (and nothing done) without them."""
    if not all(os.environ.get(v) for v in _TORCHRUN_VARS):
        return False
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl")     # env:// reads the variables above
    return True


def launch_commands(
    *,
    hosts: int,
    coordinator: str,
    arch: str,
    pods: int = 1,
    extra: str = "",
    cards_per_host: int = 8,
) -> list[str]:
    """One ``torchrun`` line per host, node rank ``i``, all meeting at
    ``coordinator`` (``host:port``)."""
    cmds = []
    for rank in range(hosts):
        cmds.append(
            f"torchrun --nnodes {hosts} --nproc-per-node {cards_per_host} --node-rank {rank} "
            f"--rdzv-backend c10d --rdzv-endpoint {coordinator} "
            f"-m repro_torch.launch.train --arch {arch} {extra}".strip()
        )
    return cmds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hosts", type=int, default=32, help="hosts a pod: 32 x 8 cards = 256")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--coordinator", default="10.0.0.2:29500")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--extra", default="--steps 10000 --ckpt-dir /shared/ckpt")
    args = ap.parse_args()
    for cmd in launch_commands(
        hosts=args.hosts * args.pods,
        coordinator=args.coordinator,
        arch=args.arch,
        pods=args.pods,
        extra=args.extra,
    ):
        print(cmd)


if __name__ == "__main__":
    main()
