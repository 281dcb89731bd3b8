"""Every cell finds its pieces by name, BENCHMARK.json keeps to the shape
the benchmark reads, and nothing the benchmark runs imports JAX or the JAX
package."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from _cellbench_small import workloads
from cellbench import layout

BENCH = layout.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_resolves_its_files_by_name(workload):
    entry = layout.cell(workload)
    cfg = layout.config(entry)
    assert (layout.ROOT / entry["config_entry"]["file"]).resolve().is_relative_to(BENCH)
    assert cfg["name"] == entry["config"]
    traffic = layout.traffic(entry["traffic"])
    drv = layout.driver(traffic["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(drv, fn))
    e2e = layout.metrics_of(workload, "end_to_end")
    per_layer = layout.metrics_of(workload, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert callable(layout.metric_reader(m["name"]))
    assert set(cfg["limits"]) >= {"count_flip_share", "count_max_diff"}


def test_benchmark_json_keeps_to_its_shape():
    spec = json.loads(layout.BENCHMARK.read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert spec["paths"] == ["cellbench"] and spec["command"] == ["python3", "cellbench/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in spec["configs"]}
    assert configs == {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("cellbench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    by_name = {m["name"]: m for m in spec["end_to_end"]}
    assert by_name["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in by_name
        for w in m.get("workloads", []):
            assert w in by_name[m["moves"]].get("workloads", [w])
        if m["name"].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path: Path) -> set[str]:
    """Top-level names a module imports (absolute imports; ``from .x``
    names its own package)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {p.relative_to(BENCH).as_posix(): _imports(p) & {"jax", "jaxlib", "flax", "repro"}
             for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        names = _imports(p)
        assert "repro_torch" not in names, p
        tree = ast.parse(p.read_text())
        inner = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert all(m == "cellbench.reference" or m.startswith("cellbench.reference.") or not m.startswith("cellbench")
                   for m in inner), (p, inner)


def test_the_run_flags_jax_by_whole_top_level_name():
    from cellbench import run

    assert run.loaded_forbidden(["torch", "repro_torch", "repro_torch.fpca", "jaxtyping", "reproduce"]) == []
    assert run.loaded_forbidden(["repro_torch", "repro.core.mapping"]) == ["repro"]
    assert run.loaded_forbidden(["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]
