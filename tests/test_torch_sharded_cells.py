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

A prefill batch that does not divide the data axes runs padded to them,
one padded share a rank, as the reference's GSPMD pads it: on the meshes
whose data extent is 4, prefill at batch 6 must cost what batch 8 costs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

ODD_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m")
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
        odd = {{}}    # prefill of an uneven batch (6 rows) and of the batch it pads to (8)
        for arch in ODD_ARCHS if math.prod({shape!r}[:-1]) == 4 else ():
            for b in (6, 8):
                rec = trace_cell(reduce_for_smoke(ARCHS[arch]), ShapeSpec("prefill", 64, b, "prefill"), mesh,
                                 CellPlan(remat="none"))
                odd[f"{{arch}}/{{b}}"] = [rec["flops_per_device"], rec["collectives"]["total_wire_bytes"]]
        print(json.dumps({{"cells": out, "odd": odd}}))
    """).replace("ODD_ARCHS", repr(ODD_ARCHS))


@pytest.fixture(scope="module")
def traces():
    """One subprocess a mesh, all started at once; ``traces(mesh)`` waits
    for that mesh's records."""
    procs = {name: subprocess.Popen([sys.executable, "-c", _code(*MESHES[name])], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True) for name in MESHES}
    done = {}

    def records(name: str) -> dict:
        if name not in done:
            out, err = procs[name].communicate(timeout=300)
            assert procs[name].returncode == 0, err[-3000:]
            done[name] = json.loads(out.strip().splitlines()[-1])
        return done[name]

    yield records
    for p in procs.values():
        p.kill()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_smoke_cell_traces_on_a_sharded_mesh(traces, mesh):
    out = traces(mesh)["cells"]
    assert len(out) == 40
    failed = {cell: why for cell, why in out.items() if isinstance(why, str) and why != "skipped"}
    assert not failed, failed
    for cell, (flops, wire, params) in ((c, r) for c, r in out.items() if r != "skipped"):
        assert flops > 0 and params > 0, cell
        assert wire > 0, cell       # a sharded step moves bytes between ranks


@pytest.mark.parametrize("mesh", ["data4_model2", "pod2_data2_model2"])
def test_an_uneven_prefill_batch_costs_its_padded_batch(traces, mesh):
    """Prefill at batch 6 against batch 8 on a data extent of 4: FLOPs a
    rank within 2%; on ``data4_model2`` wire bytes within 10% too (the
    cache fill's all-to-all).  Before the padding, batch 6 replicated over
    the data axis and cost 1.75x / 4.0x (qwen3) and 1.31x / 1.60x (granite).
    On the three-axis mesh wire bytes are not held: batch 6's cache keeps
    its rows whole and shards the sequence (``cache_shardings``, the
    reference's rule), so its fill brings every real row to each pod, where
    batch 8's fill is local (qwen3 +49,152 bytes on torch 2.11 and 2.13
    alike: 1.18x and 1.09x of their different plans), and DTensor plans
    granite's expert matmuls differently at batch 6's capacity (120 slots
    against 160: capacity counts real tokens)."""
    odd = traces(mesh)["odd"]
    for arch in ODD_ARCHS:
        (flops6, wire6), (flops8, wire8) = odd[f"{arch}/6"], odd[f"{arch}/8"]
        assert flops6 <= 1.02 * flops8, (arch, flops6, flops8)
        if mesh == "data4_model2":
            assert wire6 <= 1.10 * wire8, (arch, wire6, wire8)


_PAD_LAYOUT = textwrap.dedent(f"""
    import json, sys
    sys.path.insert(0, {str(ROOT / 'src')!r})
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import compat
    bad = []
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
        block = rank // 2                       # this rank's (pod, data) block, in mesh order
        rows = [Shard(0), Shard(0), Replicate()]
        for n in range(1, 13):
            n_pad = compat.padded_rows(mesh, n)
            mask = compat.real_row_mask(mesh, n, n_pad).view(4, -1)
            counts = mask.sum(1).tolist()
            (size,), (offset,) = compat.box((n,), mesh, rows)
            x = compat.wrap(torch.empty(size, 3, device="meta"), mesh, rows, (n, 3))
            padded = compat.pad_rows(x, n_pad)
            back = compat.unpad_rows(padded, n)
            ok = (n_pad % 4 == 0 and n_pad - 4 < n <= n_pad and size == counts[block]
                  and (size == 0 or offset == sum(counts[:block])) and mask[:, 0].tolist() == [c > 0 for c in counts]
                  and padded._local_tensor.shape == (n_pad // 4, 3) and back._local_tensor.shape == (size, 3)
                  and tuple(back.shape) == (n, 3))
            if not ok:
                bad.append((rank, n, size, offset, counts))
        dist.destroy_process_group()
    print(json.dumps(bad))
""")


def test_padded_rows_hold_each_ranks_share_of_the_real_rows():
    """On every rank of a fake (pod=2, data=2, model=2) group and for 1-12
    rows: a padded batch's blocks hold each rank's share of DTensor's
    uneven split of the real rows (``real_row_mask`` against
    ``compat.box``), and ``pad_rows`` / ``unpad_rows`` give each rank its
    padded block and its real rows back."""
    proc = subprocess.run([sys.executable, "-c", _PAD_LAYOUT], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
