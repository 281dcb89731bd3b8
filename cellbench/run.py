"""Run one cell of the port's benchmark once and print its result line.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (``PYTHONPATH=src python -m cellbench.run ...``
works too).  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with the reference beside its limit, which are also the
last lines on standard error.

Exits non-zero, printing no result, when the card or the cell's chip count
is missing, when the checkout holds no program, or when JAX or the JAX
package was loaded by the time the window closed.  ``--control tf32`` puts
the reference, computed with TF32 products, in the program's place for the
check (the run that must come out not correct).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches at fixed paths inside the checkout, so only a
# checkout's first run builds
CACHE = ROOT / "build" / "cellbench"


def _paths() -> None:
    # run as a script, the script's folder leads sys.path: its modules are
    # cellbench's, never top-level names
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "cellbench"]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # where the interpreter runs with bytecode writing off
    # (PYTHONDONTWRITEBYTECODE) and the installed packages ship no
    # bytecode, every process compiles each module it imports from source,
    # seconds for torch alone: the bytecode is kept in the checkout instead
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden(modules=None) -> list[str]:
    """Top-level names among ``modules`` (default: ``sys.modules``) that are
    JAX or the JAX package, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & set(FORBIDDEN))


def _fail(code: int, msg: str) -> None:
    print(f"cellbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)
    _paths()
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(2, f"no program under {ROOT / 'src'}: this checkout holds only the benchmark")
    from cellbench import harness, layout

    try:
        entry = layout.cell(args.workload)
    except KeyError as e:
        _fail(2, str(e))
    import torch

    t_imports = time.perf_counter()
    if not torch.cuda.is_available():
        _fail(3, "no CUDA device: the benchmark measures the card and runs nowhere else")
    if torch.cuda.device_count() < entry["chips"]:
        _fail(3, f"{args.workload} needs {entry['chips']} cards, this machine has {torch.cuda.device_count()}")
    torch.cuda.init()
    t_cuda = time.perf_counter()
    notes = [f"setup: imports {t_imports - T_START!r} s, CUDA start {t_cuda - t_imports!r} s"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metric_kind = "per_layer" if args.trace else "end_to_end"
    names = [m["name"] for m in layout.metrics_of(args.workload, metric_kind)]
    result = harness.run_cell(
        args.workload, layout.config(entry), layout.traffic(entry["traffic"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda", 0), metrics=names,
        t_start=T_START, control=args.control, notes=notes,
    )
    found = loaded_forbidden()
    if found:
        _fail(4, f"loaded in the measured process: {', '.join(found)}")
    lines = result.pop("lines")
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
