"""Roofline terms of a traced step, the port of ``repro.launch.roofline``.

Three terms per (arch, shape, mesh), all in seconds:

    compute    = FLOPs_per_rank / peak_FLOPs_per_card
    memory     = bytes_per_rank / HBM_bandwidth
    collective = max(NVLink wire bytes / NVLink rate,
                     network wire bytes / network rate)

The counts come from :func:`repro_torch.launch.step_analysis.analyze_step`
(the reference reads them from optimized HLO).  Each collective is charged
its ring-algorithm wire traffic, the reference's factors:

    all-gather        : out_bytes * (n-1)/n
    reduce-scatter    : out_bytes * (n-1)          (out is the shard)
    all-reduce        : 2 * bytes * (n-1)/n        (RS + AG)
    all-to-all        : bytes * (n-1)/n
    collective-permute: bytes

Hardware model: one H100 SXM, the published dense bf16 peak of 989 TFLOP/s
and 3.35 TB/s of HBM3.  A collective whose group stays on one host of 8
cards runs over NVLink at 450 GB/s each way; one that crosses hosts (the
``data`` and ``pod`` axes of the production mesh) runs over the network.
The network rate is an assumption, not a measurement: a DGX H100 gives
each card one 400 Gb/s port, 50 GB/s.  The two kinds of link run
concurrently, so the collective term is the larger of the two times.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "HW",
    "wire_factor",
    "collective_bytes",
    "roofline_terms",
    "model_flops",
    "summarize_cell",
]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12      # bf16 dense / H100 SXM
    hbm_bw: float = 3.35e12         # B/s
    nvlink_bw: float = 450e9        # B/s each way, to the other cards of the host
    network_bw: float = 50e9        # B/s per card across hosts (assumed: 400 Gb/s)
    cards_per_host: int = 8


def wire_factor(op: str, n: int) -> float:
    """Ring-algorithm wire bytes per result byte of ``op`` over ``n`` ranks."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_bytes(stats: Any) -> dict[str, Any]:
    """Per-rank wire bytes by collective op, from a step counter's record
    (:class:`repro_torch.launch.step_analysis.StepStats`)."""
    return {
        "per_op": dict(stats.collectives),
        "total_wire_bytes": float(stats.wire_bytes),
        "network_wire_bytes": float(stats.wire_bytes_network),
        "n_whiles": stats.n_whiles,
        "unknown_trip_whiles": stats.unknown_trip_whiles,
    }


def roofline_terms(
    flops: float, bytes_accessed: float, wire_bytes: float, hw: HW = HW(),
    *, network_bytes: float | None = None,
) -> dict[str, float]:
    """The three terms; ``network_bytes`` is the part of ``wire_bytes``
    that crosses hosts (all of it when not given)."""
    net = wire_bytes if network_bytes is None else network_bytes
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": bytes_accessed / hw.hbm_bw,
        "collective_s": max((wire_bytes - net) / hw.nvlink_bw, net / hw.network_bw),
    }
    terms["dominant"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    terms["bound_s"] = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return terms


def model_flops(cfg, shape) -> float:
    """Useful FLOPs: 6 N_active tokens to train, 2 N_active tokens to
    prefill or decode (one token per sequence per decode step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def summarize_cell(
    stats: Any, cfg, shape, world: int, hw: HW = HW(), *, per_device_bytes: dict | None = None
) -> dict[str, Any]:
    """The full roofline record of one traced cell: the reference's keys,
    with ``xla_cost_analysis_raw`` and ``memory`` replaced by
    ``step_counter_raw`` (the counter's diagnostics) and
    ``per_device_bytes`` (:func:`repro_torch.launch.cells.trace_cell`'s
    per-rank bytes)."""
    colls = collective_bytes(stats)
    terms = roofline_terms(stats.flops, stats.bytes_proxy, colls["total_wire_bytes"], hw,
                           network_bytes=colls["network_wire_bytes"])
    mf = model_flops(cfg, shape)
    flops_global = stats.flops * world
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "world": world,
        "flops_per_device": float(stats.flops),
        "bytes_per_device": float(stats.bytes_proxy),
        "collectives": colls,
        "terms": terms,
        "model_flops": mf,
        "useful_flop_ratio": mf / flops_global if flops_global else 0.0,
        "roofline_mfu": mf / (world * hw.peak_flops * terms["bound_s"]) if terms["bound_s"] else 0.0,
        "step_counter_raw": {
            "bytes_all_results": float(stats.bytes_all_results),
            "n_ops": stats.n_ops,
        },
        "per_device_bytes": per_device_bytes or {},
    }
