"""Every LM smoke cell traces under a sharded mesh, on the host.

The dry run (:mod:`repro_torch.launch.dryrun`) traces each cell's step on
meta tensors laid out as DTensors over a fake process group; a cell fails
when an op of the model code has no sharding strategy for its layout, or
a view splits a shard into parts that are not whole heads.  Here each
architecture's ``reduce_for_smoke`` config (4:2 heads of 16, 8 experts,
2 layers) traces train, prefill, decode at batch 8 and decode at batch 1
(the sequence-parallel cache) on three meshes of a fake 8-rank group:
``(data=4, model=2)``, ``(data=2, model=4)`` (the KV heads do not divide
the model axis, as yi-9b's 4 and phi3-medium-14b's 10 do not divide 8 on
the production mesh) and ``(pod=2, data=2, model=2)``, the multi-pod
layout.  Cells skip where ``shape_applicable`` skips them, as the
reference's do.  Each mesh runs in a subprocess of its own (a process
holds one default group); the three start together, since the host's
torch plans DTensor redistributions on the three-axis mesh slowly (about
80 s of the file).  Numerics under a mesh are held in
``tests/test_torch_sharded_steps.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


def _code(shape: tuple, axes: tuple) -> str:
    return textwrap.dedent(f"""
        import json, math, sys, traceback
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod({shape!r}))
        from repro_torch import compat
        from repro_torch.configs import ARCHS, reduce_for_smoke, shape_applicable
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.cells import CellPlan, trace_cell
        mesh = compat.make_mesh({shape!r}, {axes!r})
        shapes = [ShapeSpec("train", 64, 8, "train"), ShapeSpec("prefill", 64, 8, "prefill"),
                  ShapeSpec("decode", 64, 8, "decode"), ShapeSpec("decode_batch1", 64, 1, "decode")]
        out = {{}}
        for arch in sorted(ARCHS):
            cfg = reduce_for_smoke(ARCHS[arch])
            for s in shapes:
                if not shape_applicable(cfg, s)[0]:
                    out[f"{{arch}}/{{s.name}}"] = "skipped"
                    continue
                try:
                    rec = trace_cell(cfg, s, mesh, CellPlan(remat="none"))
                    out[f"{{arch}}/{{s.name}}"] = [rec["flops_per_device"], rec["collectives"]["total_wire_bytes"],
                                                   rec["per_device_bytes"]["params"]]
                except Exception as e:
                    where = [f"{{f.filename.split('/')[-1]}}:{{f.lineno}}" for f in traceback.extract_tb(e.__traceback__)
                             if "repro_torch" in f.filename][-1:]
                    out[f"{{arch}}/{{s.name}}"] = f"{{type(e).__name__}} at {{where}}: {{str(e)[:300]}}"
        print(json.dumps(out))
    """)


@pytest.fixture(scope="module")
def traces():
    """One subprocess a mesh, all started at once."""
    procs = {name: subprocess.Popen([sys.executable, "-c", _code(*MESHES[name])], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True) for name in MESHES}
    yield procs
    for p in procs.values():
        p.kill()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_smoke_cell_traces_on_a_sharded_mesh(traces, mesh):
    proc = traces[mesh]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    out = json.loads(out.strip().splitlines()[-1])
    assert len(out) == 40
    failed = {cell: why for cell, why in out.items() if isinstance(why, str) and why != "skipped"}
    assert not failed, failed
    for cell, (flops, wire, params) in ((c, r) for c, r in out.items() if r != "skipped"):
        assert flops > 0 and params > 0, cell
        assert wire > 0, cell       # a sharded step moves bytes between ranks
