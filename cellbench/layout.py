"""Where the benchmark finds each piece of a cell, by the names in
``BENCHMARK.json``:

* a configuration: the ``file`` its entry names (``configs/<config>.json``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
  loop that serves it, ``drivers/<driver>.py``;
* a metric: ``metrics/<name>.py``, or for a name with a family suffix
  (``step_mfu.batch``) ``metrics/<name before the first dot>.py`` when the
  full name has no file of its own.

Adding a cell, a configuration or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def cell(workload: str, spec: dict | None = None) -> dict:
    """The workload entry named ``workload``, with its configuration entry
    under ``"config_entry"``; raises ``KeyError`` naming the choices."""
    spec = spec or benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    entry = dict(cells[workload])
    entry["config_entry"] = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return entry


def config(entry: dict) -> dict:
    return json.loads((ROOT / entry["config_entry"]["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _load(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def driver(name: str) -> ModuleType:
    path = BENCH_DIR / "drivers" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"traffic driver {name!r}: no {path.relative_to(ROOT)}")
    return _load(path, f"cellbench.drivers.{name}")


def metric_path(name: str) -> Path:
    own = BENCH_DIR / "metrics" / f"{name}.py"
    family = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    if own.exists():
        return own
    if family.exists():
        return family
    raise FileNotFoundError(f"metric {name!r}: neither {own.relative_to(ROOT)} nor {family.relative_to(ROOT)}")


def metric_reader(name: str):
    """The ``read(ctx) -> float | None`` of metric ``name``."""
    return _load(metric_path(name), f"cellbench.metrics.{name.replace('.', '_')}").read


def metrics_of(workload: str, kind: str, spec: dict | None = None) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it under ``workloads`` (an end-to-end metric that lists
    no cells, such as ``setup_s``, is every cell's)."""
    spec = spec or benchmark()
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return [m for m in spec["per_layer"] if workload in m["workloads"]]
