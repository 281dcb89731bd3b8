"""The readings the check's limits are set from, at a cell's own size, many
seeds in one process:

    python3 cellbench/tests/readings.py --workload <name> --seeds 11,12,13 \
        [--seconds 2] [--control tf32 | --fault <name>]

Each seed is one run of the cell through the harness (set-up, a short
window, the check) with the program as it is, with the TF32 control in its
place, or with a fault of ``_cellbench_faults.py`` planted underneath; one
JSON line a seed gives ``correct``, ``failed`` and each compared number
beside its limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(HERE), str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main() -> None:
    import pytest
    import torch

    import _cellbench_faults as faults
    from cellbench import harness, layout

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("readings.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = layout.cell(args.workload)
    names = [m["name"] for m in layout.metrics_of(args.workload, "end_to_end")]
    mode = args.fault or args.control or "program"
    for seed in (int(s) for s in args.seeds.split(",")):
        with pytest.MonkeyPatch.context() as mp:
            if args.fault:
                faults.FAULTS[args.fault](mp)
            r = harness.run_cell(args.workload, layout.config(entry), layout.traffic(entry["traffic"]), seed=seed,
                                 seconds=args.seconds, trace=False, device=torch.device("cuda", 0), metrics=names,
                                 control=args.control)
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed, "correct": r["correct"],
                          "failed": r["failed"], "attempted": r["attempted"], "checks": r["checks"]}), flush=True)


if __name__ == "__main__":
    main()
