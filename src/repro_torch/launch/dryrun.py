"""Multi-pod dry run, the port of ``repro.launch.dryrun``: trace every
(architecture x shape x mesh) cell on the production meshes and write its
per-rank bytes, counts and roofline terms.  Run it as a module::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fpca-frontend --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells yi-9b:prefill_32k,mamba2-2.7b:decode_32k

The reference forces 512 host devices through ``XLA_FLAGS`` and compiles
each cell.  This module instead creates a process group of the mesh's world
size on torch's fake backend (``torch.testing._internal.distributed.fake_pg``:
every collective returns at once, moving nothing), builds the
:class:`~torch.distributed.device_mesh.DeviceMesh` as rank 0 of it, and
runs each step once on meta tensors under the step counter
(:func:`repro_torch.launch.cells.trace_cell`).  Nothing is allocated and no
card is needed.  A process holds one default group, and the fake one
cannot live beside a real one, so the dry run is a process of its own, and
``--mesh both`` runs the multi-pod cells in a second one.

``--block-k`` keeps the reference's flag and raises: it set the KV block of
the reference's Pallas flash kernel (``attn_block_k``), while the port's
flash kernels tile the KV sequence by a fixed 64 rows, so no value would
change what is traced.

Records go to ``artifacts/dryrun/<tag>/<arch>__<shape>__<mesh>.json`` (the
reference's layout; an ``.error`` file beside a cell that failed), and the
process exits 1 when any requested cell failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"
_WORLD = {False: 256, True: 512}


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; the dry run needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh_tag(multi_pod: bool) -> str:
    return "multi_pod_2x32x8" if multi_pod else "single_pod_32x8"


def run_fpca_cell(
    shape_name: str, multi_pod: bool, *,
    fuse_phases: bool = False, bf16: bool = False, row_shard: bool = False,
) -> dict:
    """Paper-representative cell: the FPCA frontend at production scale."""
    from repro_torch.core.curvefit import fit_bucket_model
    from repro_torch.launch.fpca_cell import FPCA_SHAPES, build_fpca_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import HW, collective_bytes, roofline_terms
    from repro_torch.launch.step_analysis import analyze_step

    _fake_group(_WORLD[multi_pod])
    shape = FPCA_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = fit_bucket_model(device="cpu")
    t0 = time.time()
    step, args, info = build_fpca_cell(
        shape, mesh, model, fuse_phases=fuse_phases,
        compute_dtype=torch.bfloat16 if bf16 else None, row_shard=row_shard, device="meta",
    )
    stats = analyze_step(step, *args, world=mesh.size())
    t_trace = time.time() - t0
    colls = collective_bytes(stats)
    terms = roofline_terms(stats.flops, stats.bytes_proxy, colls["total_wire_bytes"],
                           network_bytes=colls["network_wire_bytes"])
    model_flops = info.model_flops()
    hw = HW()
    images = args[0]
    h_o = images.shape[1] // info.spec.stride
    w_o = images.shape[2] // info.spec.stride
    windows = images.shape[0] * h_o * w_o
    n = info.spec.n_active_pixels
    return {
        "arch": "fpca-frontend",
        "shape": shape_name,
        "mesh": _mesh_tag(multi_pod),
        "world": mesh.size(),
        "trace_s": round(t_trace, 2),
        "flops_per_device": stats.flops,
        "bytes_per_device": stats.bytes_proxy,
        "collectives": colls,
        "terms": terms,
        "model_flops": model_flops,
        "useful_flop_ratio": model_flops / (stats.flops * mesh.size()) if stats.flops else 0.0,
        "roofline_mfu": (
            model_flops / (mesh.size() * hw.peak_flops * terms["bound_s"]) if terms["bound_s"] else 0.0
        ),
        "step_counter_raw": {"bytes_all_results": stats.bytes_all_results, "n_ops": stats.n_ops},
        "per_device_bytes": {
            "frames": images.numel() * images.element_size(),
            "patches_f32": windows * n * 4,
            "counts_f32": windows * info.spec.out_channels * 4,
            "windows": windows,
        },
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, plan, cfg_overrides: dict | None = None) -> dict:
    import dataclasses as _dc

    from repro_torch.configs import ARCHS, SHAPES, shape_applicable
    from repro_torch.launch.cells import trace_cell
    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS[arch]
    if cfg_overrides:
        cfg = _dc.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    _fake_group(_WORLD[multi_pod])
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = trace_cell(cfg, shape, mesh, plan)
    rec.update(
        mesh=_mesh_tag(multi_pod),
        plan={
            "remat": plan.remat,
            "n_micro": plan.n_micro,
            "fsdp": plan.policy.fsdp,
            "tp": plan.policy.tp,
            "expert_parallel": plan.policy.expert_parallel,
        },
    )
    return rec


def _parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.fpca_cell import FPCA_SHAPES

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS) + ["fpca-frontend"], help="single architecture")
    ap.add_argument("--shape", choices=sorted(SHAPES) + sorted(FPCA_SHAPES), help="single shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run the full matrix")
    ap.add_argument("--cells", default="", help="comma-separated arch:shape cells, traced in one process")
    ap.add_argument("--tag", default="baseline", help="artifact subdirectory")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=0.0, help="override MoE capacity")
    ap.add_argument("--block-k", type=int, default=0, help="the reference's flash KV block; raises: the port's kernel tiles KV by 64")
    ap.add_argument("--no-vocab-shard", action="store_true", help="disable logits vocab reshard")
    ap.add_argument("--moe-local-dispatch", action="store_true", help="per-sequence expert routing")
    ap.add_argument("--fpca-fuse", action="store_true", help="fpca cell: fuse pos/neg phases")
    ap.add_argument("--fpca-bf16", action="store_true", help="fpca cell: bf16 operands")
    ap.add_argument("--fpca-rowshard", action="store_true", help="fpca cell: shard image rows over model")
    ap.add_argument("--no-tp", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--no-expert-tp", action="store_true", help="replicate expert ff at use")
    ap.add_argument("--force", action="store_true", help="recompute existing artifacts")
    return ap


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.cells import CellPlan
    from repro_torch.launch.fpca_cell import FPCA_SHAPES
    from repro_torch.launch.sharding import ShardingPolicy

    argv = sys.argv[1:] if argv is None else argv
    ap = _parser()
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.cells):
        ap.error("pass --all, --arch or --cells")
    if args.block_k:
        ap.error("--block-k has no effect in the port: its flash kernels tile the KV sequence by a fixed 64 rows")
    if args.mesh == "both":
        # one default group a process: the multi-pod cells run in a second one
        rcs = [subprocess.call([sys.executable, "-m", "repro_torch.launch.dryrun", *_with_mesh(argv, m)])
               for m in ("single", "multi")]
        raise SystemExit(1 if any(rcs) else 0)

    plan = CellPlan(
        policy=ShardingPolicy(
            fsdp=not args.no_fsdp,
            tp=not args.no_tp,
            expert_parallel=args.expert_parallel,
            expert_tp=not args.no_expert_tp,
        ),
        remat=args.remat,
        n_micro=args.n_micro,
    )
    archs = [args.arch] if args.arch else sorted(ARCHS)
    if args.all and not args.arch:
        archs = archs + ["fpca-frontend"]
    multi = args.mesh == "multi"

    out_dir = ARTIFACTS / args.tag
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(arch, shape_name) for arch in archs
                 for shape_name in ([args.shape] if args.shape else
                                    sorted(FPCA_SHAPES) if arch == "fpca-frontend" else sorted(SHAPES))]
    failures = []
    for arch, shape_name in cells:
        mesh_tag = "multi" if multi else "single"
        path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
        if path.exists() and not args.force:
            print(f"[skip existing] {path.name}")
            continue
        label = f"{arch} x {shape_name} x {mesh_tag}"
        print(f"=== {label} ===", flush=True)
        try:
            if arch == "fpca-frontend":
                rec = run_fpca_cell(
                    shape_name, multi,
                    fuse_phases=args.fpca_fuse, bf16=args.fpca_bf16, row_shard=args.fpca_rowshard,
                )
            else:
                overrides = {}
                if args.capacity_factor:
                    overrides["moe_capacity_factor"] = args.capacity_factor
                if args.no_vocab_shard:
                    overrides["logits_vocab_shard"] = False
                if args.moe_local_dispatch:
                    overrides["moe_local_dispatch"] = True
                rec = run_cell(arch, shape_name, multi, plan, overrides)
            path.write_text(json.dumps(rec, indent=2, default=float))
            if "skipped" in rec:
                print(f"[skipped] {rec['skipped']}")
            else:
                t = rec["terms"]
                print(
                    f"[ok] trace={rec['trace_s']}s flops={rec['flops_per_device']:.4g} "
                    f"bytes={rec['bytes_per_device']:.4g} "
                    f"wire={rec['collectives']['total_wire_bytes']:.4g} "
                    f"compute={t['compute_s']:.4g}s memory={t['memory_s']:.4g}s "
                    f"collective={t['collective_s']:.4g}s dominant={t['dominant']} "
                    f"per_device_bytes={json.dumps(rec['per_device_bytes'])}",
                    flush=True,
                )
        except Exception as e:  # noqa: BLE001 — sweep must survive cell bugs
            failures.append(label)
            path.with_suffix(".error").write_text(traceback.format_exc())
            print(f"[FAIL] {label}: {type(e).__name__}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells traced OK")


def _with_mesh(argv: list[str], mesh: str) -> list[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--mesh":
            skip = True
            continue
        if a.startswith("--mesh="):
            continue
        out.append(a)
    return out + ["--mesh", mesh]


if __name__ == "__main__":
    main()
