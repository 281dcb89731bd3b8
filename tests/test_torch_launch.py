"""The port's launch tooling (``repro_torch.launch``, ``repro_torch.compat``)
against the reference's (``repro.launch``), on the host.

Tolerances, each with its reason:

* shapes, ``shape_applicable``, every parameter and cache leaf's sharding
  spec, the dot FLOPs of the step counter on the twins of
  ``tests/test_hlo_analysis.py``'s computations: equal (the same rules and
  the same integer arithmetic);
* ``bytes_proxy`` over a loop: exactly proportional to the trip count (the
  eager counter sees every trip; the reference's ratio lies between 2 and
  3.5 because of its entry-level constants);
* cells: a world-1 cell's step equals the unmeshed step bit for bit (the
  shard hooks are the identity on plain tensors).

Process groups are process-global: the world-1 gloo group these tests set
up lives in the test process; the fake 8- and 256-rank groups run in
subprocesses of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import sharding as j_sharding
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.transformer import init_model as j_init_model
from repro_torch.configs import ARCHS, SHAPES, reduce_for_smoke, shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import cluster, sharding
from repro_torch.launch.cells import CellPlan, build_cell, trace_cell
from repro_torch.launch.mesh import data_axes, data_extent, make_host_mesh
from repro_torch.launch.roofline import HW, model_flops, roofline_terms, wire_factor
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models.transformer import init_model
from repro_torch.training.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
D = 128


class _Mesh:
    """Just the axis names and extents a sharding rule reads (a fake mesh
    of any shape without a process group of that size)."""

    def __init__(self, shape: tuple, axes: tuple):
        self.shape, self.mesh_dim_names, self.ndim = shape, axes, len(axes)


def _ref_specs(tree, shardings) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {j_sharding._path_str(p): _norm(tuple(s.spec), leaf.ndim) for (p, leaf), s in zip(flat, specs)}


def _port_specs(tree, layouts) -> dict:
    return {p: _norm(sharding.spec_of(lay, x.ndim), x.ndim)
            for p, x, lay in zip(sharding._paths(tree), tree_leaves(tree), tree_leaves(layouts))}


def _norm(spec: tuple, ndim: int) -> tuple:
    """Pad to ``ndim`` and write a one-axis tuple as the axis name."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def test_shapes_match_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in J_SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_applicable(ARCHS[arch], SHAPES[name]) == j_shape_applicable(J_ARCHS[arch], J_SHAPES[name])


POLICIES = [dict(), dict(expert_parallel=True), dict(fsdp=False), dict(tp=False), dict(expert_tp=False)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_match_reference(arch):
    """Every leaf's placements, as axis names, equal the reference's spec
    under each policy (the reference's tests/test_cells.py checks rank only)."""
    j_mesh = jax.sharding.AbstractMesh((4, 2), ("data", "model"))
    mesh = _Mesh((4, 2), ("data", "model"))
    j_cfg, cfg = reduce_for_smoke(J_ARCHS[arch]), reduce_for_smoke(ARCHS[arch])
    j_shapes = jax.eval_shape(lambda k: j_init_model(k, j_cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
    shapes = init_model(cfg, device="meta")
    for kw in POLICIES:
        want = _ref_specs(j_shapes, j_sharding.param_shardings(j_shapes, j_mesh, j_sharding.ShardingPolicy(**kw)))
        got = _port_specs(shapes, sharding.param_shardings(shapes, mesh, sharding.ShardingPolicy(**kw)))
        assert got == want, kw


@pytest.mark.parametrize("arch,batch,mesh_shape", [
    ("qwen3-1.7b", 8, (4, 2)), ("qwen3-1.7b", 1, (4, 2)), ("zamba2-7b", 8, (2, 2, 2)),
    ("mamba2-2.7b", 1, (2, 4)), ("h2o-danube-1.8b", 4, (4, 2)), ("granite-moe-3b-a800m", 2, (8, 1)),
])
def test_cache_shardings_match_reference(arch, batch, mesh_shape):
    """KV / SSM / conv cache specs for a batch that divides the data extent
    and one that does not (the batch-1 sequence split), with and without
    ``seq_shard_batch1``."""
    from repro.models.transformer import init_cache as j_init_cache
    from repro_torch.models.transformer import init_cache

    axes = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    j_mesh = jax.sharding.AbstractMesh(mesh_shape, axes)
    mesh = _Mesh(mesh_shape, axes)
    j_cfg, cfg = reduce_for_smoke(J_ARCHS[arch]), reduce_for_smoke(ARCHS[arch])
    j_cache = jax.eval_shape(lambda: j_init_cache(j_cfg, batch, 64))
    cache = init_cache(cfg, batch, 64, device="meta")
    for kw in (dict(), dict(seq_shard_batch1=False), dict(tp=False)):
        pol = (j_sharding.ShardingPolicy(**kw), sharding.ShardingPolicy(**kw))
        want = _ref_specs(j_cache, j_sharding.cache_shardings(j_cache, j_mesh, batch, pol[0]))
        got = _port_specs(cache, sharding.cache_shardings(cache, mesh, batch, pol[1]))
        assert got == {k: v for k, v in want.items() if k in got}, kw
        assert set(want) - set(got) <= {"cross/k", "cross/v"}    # the port fills cross K/V at prefill


def test_batch_shardings_and_layout_round_trip():
    mesh = _Mesh((2, 4, 8), ("pod", "data", "model"))
    batch = {"tokens": torch.empty((8, 16), device="meta"), "step": torch.empty((), device="meta")}
    lays = sharding.batch_shardings(mesh, batch)
    assert sharding.spec_of(lays["tokens"], 2) == (("pod", "data"), None)
    assert sharding.spec_of(lays["step"], 0) == ()
    assert data_axes(mesh) == ("pod", "data") and data_extent(mesh) == 8
    for spec in [(None, "model"), ("data", None, "model"), (("pod", "data"), "model")]:
        assert sharding.spec_of(sharding.layout_for(mesh, spec), len(spec)) == spec
    with pytest.raises(ValueError, match="used twice"):
        sharding.layout_for(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="not in mesh"):
        sharding.layout_for(mesh, ("expert",))


# ---------------------------------------------------------------------------
# the step counter against analyze_hlo on the twins of test_hlo_analysis.py
# ---------------------------------------------------------------------------


def _hlo(fn, *sds) -> object:
    return analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text(), world=1)


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def test_loop_flops_match_analyze_hlo():
    w_j, L = jnp.ones((D, D), jnp.float32), 7
    sds = jax.ShapeDtypeStruct((D, D), jnp.float32)
    want = _hlo(lambda x: jax.lax.scan(lambda c, _: (c @ w_j, None), x, None, length=L)[0], sds).flops
    w = _meta(D, D)

    def stack(x):
        for _ in range(L):
            x = x @ w
        return x

    st = analyze_step(stack, _meta(D, D))
    assert st.flops == want == L * 2 * D**3
    assert (st.n_whiles, st.unknown_trip_whiles) == (0, 0)


def test_nested_loop_flops_match_analyze_hlo():
    w_j = jnp.ones((D, D), jnp.float32)

    def j_fn(x):
        inner = lambda c, _: (c @ w_j, None)   # noqa: E731
        return jax.lax.scan(lambda c, _: (jax.lax.scan(inner, c, None, length=3)[0], None), x, None, length=5)[0]

    want = _hlo(j_fn, jax.ShapeDtypeStruct((D, D), jnp.float32)).flops
    w = _meta(D, D)

    def fn(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    assert analyze_step(fn, _meta(D, D)).flops == want == 15 * 2 * D**3


@pytest.mark.parametrize("eq,xs,ws", [("bsd,dv->bsv", (2, 16, 32), (32, 64)), ("bij,bjk->bik", (3, 8, 24), (3, 24, 40))])
def test_vocab_and_batched_dot_flops_match_analyze_hlo(eq, xs, ws):
    sds = (jax.ShapeDtypeStruct(xs, jnp.float32), jax.ShapeDtypeStruct(ws, jnp.float32))
    want = _hlo(lambda x, w: jnp.einsum(eq, x, w), *sds).flops
    assert analyze_step(lambda x, w: torch.einsum(eq, x, w), _meta(*xs), _meta(*ws)).flops == want


def test_bytes_proxy_scales_with_trip_count():
    w = _meta(D, D)

    def fn(x, n):
        for _ in range(n):
            x = x @ w
        return x

    b3, b9 = (analyze_step(fn, _meta(D, D), n).bytes_proxy for n in (3, 9))
    assert b9 == 3 * b3 == 3 * 3 * 3 * (4 * D * D)


def test_counter_counts_local_dtensor_ops_and_collectives_on_a_fake_group():
    """On a fake 8-rank group (a subprocess): a (4, 2)-sharded matmul counts
    its local shards' FLOPs, not the global product's; an all-reduce in a
    loop charges trips x the ring factor; the qwen3 smoke train cell
    shards its parameters' bytes."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        from repro_torch import compat
        from repro_torch.configs import ARCHS, reduce_for_smoke
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.cells import CellPlan, trace_cell
        from repro_torch.launch.step_analysis import analyze_step
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = compat.make_mesh((4, 2), ("data", "model"))
        x = DTensor.from_local(torch.empty(16, 256, device="meta"), mesh, [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(64, 64, device="meta"), mesh, [Shard(0), Shard(1)], run_check=False)
        mm = analyze_step(lambda a, b: a @ b, x, w, world=8)
        def loop(t):
            for _ in range(4):
                t = funcol.all_reduce(t, "sum", dist.group.WORLD)
            return t
        ar = analyze_step(loop, torch.ones(1024), world=8)
        cell = trace_cell(reduce_for_smoke(ARCHS["qwen3-1.7b"]), ShapeSpec("t", 64, 8, "train"), mesh, CellPlan(remat="none"))
        print(json.dumps({{"mm_flops": mm.flops, "ar": ar.collectives, "ar_wire": ar.wire_bytes,
                           "ar_network": ar.wire_bytes_network, "cell_bytes": cell["per_device_bytes"],
                           "cell_colls": cell["collectives"]["per_op"], "cell_flops": cell["flops_per_device"]}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    # global 64x256 @ 256x128 would read 2*64*256*128; DTensor's local plan
    # multiplies 64x64 by 64x64 on each rank (x gathered, w's shard)
    assert rec["mm_flops"] == 2 * 64 * 64 * 64 < 2 * 64 * 256 * 128
    assert rec["ar"]["all-reduce"]["count"] == 4
    assert rec["ar_wire"] == pytest.approx(4 * 4096 * wire_factor("all-reduce", 8)) == 4 * 4096 * 2 * 7 / 8
    assert rec["ar_network"] == 0.0     # 8 consecutive ranks: one host
    smoke = reduce_for_smoke(ARCHS["qwen3-1.7b"])
    full_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(init_model(smoke, device="meta")))
    assert rec["cell_bytes"]["params"] < full_bytes / 4
    assert rec["cell_colls"]["all-gather"]["count"] > 0 and rec["cell_flops"] > 0


# ---------------------------------------------------------------------------
# cells and roofline on a world-1 host mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_traces_on_host_mesh(host_mesh, arch, kind):
    cfg = reduce_for_smoke(ARCHS[arch])
    shape = ShapeSpec(kind[0], 64, 4, kind)
    rec = trace_cell(cfg, shape, host_mesh, CellPlan(remat="none"))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["terms"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["collectives"]["unknown_trip_whiles"] == 0 and rec["collectives"]["total_wire_bytes"] == 0
    assert rec["model_flops"] == model_flops(cfg, shape)
    assert rec["per_device_bytes"]["params"] == sum(
        p.numel() * p.element_size() for p in tree_leaves(init_model(cfg, device="meta")))


def test_world1_cell_step_equals_unmeshed_step(host_mesh):
    """The cell's train step on real host tensors under the ambient mesh
    equals the plain step bit for bit."""
    from repro_torch import compat
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train_step import make_train_step

    cfg = reduce_for_smoke(ARCHS["qwen3-1.7b"])
    step, _ = build_cell(cfg, ShapeSpec("t", 32, 4, "train"), host_mesh, CellPlan(remat="none", n_micro=2))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32))) for k in ("tokens", "labels")}
    outs = []
    for meshed in (True, False):
        params = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        opt = init_adamw(params)
        fn = step if meshed else make_train_step(cfg, AdamWConfig(), n_micro=2, remat="none")
        with compat.set_mesh(host_mesh) if meshed else contextlib.nullcontext():
            params, opt, metrics = fn(params, opt, batch)
        outs.append((params, metrics))
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[1][1])


def test_roofline_terms_and_hw():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.network_bw) == (989e12, 3.35e12, 450e9, 50e9)
    t = roofline_terms(989e12, 3.35e12 / 2, 900e9, network_bytes=0.0)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5 and t["collective_s"] == 2.0
    assert t["dominant"] == "collective_s" and t["bound_s"] == 2.0
    t = roofline_terms(0.0, 0.0, 100e9)               # all across hosts by default
    assert t["collective_s"] == 2.0
    assert [wire_factor(op, 4) for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "x")] == [
        1.5, 0.75, 3.0, 0.75, 1.0]
    assert wire_factor("all-reduce", 1) == 0.0


def test_dryrun_fpca_cells_on_both_fake_meshes(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes the FPCA cell's records
    on the fake 256- and 512-rank meshes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tag = f"test_{os.getpid()}"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "fpca-frontend",
                           "--shape", "video_1080", "--mesh", "both", "--tag", tag, "--force"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    out = ROOT / "artifacts" / "dryrun" / tag
    try:
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        single = json.loads((out / "fpca-frontend__video_1080__single.json").read_text())
        multi = json.loads((out / "fpca-frontend__video_1080__multi.json").read_text())
    finally:
        import shutil

        shutil.rmtree(out, ignore_errors=True)
    assert (single["world"], multi["world"]) == (256, 512)
    # 256 frames over 32 and 64 data ranks: 8 and 4 frames of 224 x 224 windows
    assert single["per_device_bytes"]["windows"] == 8 * 224 * 224 == 2 * multi["per_device_bytes"]["windows"]
    assert single["flops_per_device"] == pytest.approx(2 * multi["flops_per_device"], rel=1e-3)   # + weight planes
    assert single["collectives"]["total_wire_bytes"] == 0 and single["terms"]["dominant"] == "memory_s"
    assert single["model_flops"] == 2.0 * 256 * 224 * 224 * 75 * 8 * 2


def test_dryrun_needs_a_mesh_size_group():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh()


def test_host_mesh_is_world1_gloo(host_mesh):
    import torch.distributed as dist

    assert dist.get_backend() == "gloo" and host_mesh.mesh_dim_names == ("data", "model")
    assert data_extent(host_mesh) == 1 and data_axes(host_mesh) == ("data",)


def test_maybe_shard_is_identity_without_mesh_or_on_plain_tensors(host_mesh):
    from repro_torch import compat
    from repro_torch.models.layers import maybe_shard, shard_batch

    x = torch.ones(4, 3)
    assert maybe_shard(x, "data", None) is x and shard_batch(x) is x
    assert compat.get_abstract_mesh() is None
    with compat.set_mesh(host_mesh):
        assert compat.get_abstract_mesh() is host_mesh
        assert shard_batch(x) is x
    assert compat.get_abstract_mesh() is None


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------


def test_launch_commands_one_line_per_host():
    cmds = cluster.launch_commands(hosts=4, coordinator="10.0.0.2:29500", arch="qwen3-1.7b", extra="--steps 5")
    assert len(cmds) == 4
    for i, c in enumerate(cmds):
        assert f"--node-rank {i} " in c and "--nnodes 4 " in c and "--nproc-per-node 8 " in c
        assert "--rdzv-endpoint 10.0.0.2:29500" in c and c.endswith("-m repro_torch.launch.train --arch qwen3-1.7b --steps 5")
        assert "LIBTPU" not in c


def test_maybe_init_distributed_without_torchrun_variables(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert cluster.maybe_init_distributed() is False


def test_dryrun_block_k_raises():
    """``--block-k`` keeps the reference's flag but has nothing to set: the
    port's flash kernels tile the KV sequence by a fixed 64 rows."""
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--block-k", "256"])
    assert exc.value.code == 2
