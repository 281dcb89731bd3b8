"""One run of one cell: set-up, the measured window, the check, the metrics.

:func:`run_cell` builds the program under test from the configuration's
file (``repro_torch``'s ``FPCAProgram`` / ``FPCAModelProgram`` through
``fpca.compile``), makes its weights and the calibration from the seed,
hands the traffic mix to its driver (``drivers/<driver>.py``: ``setup``
puts the compiled handle under ``ctx.state["handle"]``, ``window``,
``check``), and reads every metric the cell reports through
its reader (``metrics/<name>.py``).  Nothing here names a cell.

``control="tf32"`` puts the reference, computed with TF32 products, in the
program's place for the check: the run that shows the limits catch the
precision a later change could slip in.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
from typing import Any

import numpy as np
import torch

from cellbench import calibration, compare, layout, roofline
from cellbench.timing import reduce as reduce_trace

# caches the benchmark keeps at fixed paths inside the checkout
CACHE = layout.ROOT / "build" / "cellbench"


@dataclasses.dataclass
class Ctx:
    """What a driver builds and what the metric readers read."""

    workload: str
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    calib: dict
    weights: dict
    state: dict = dataclasses.field(default_factory=dict)    # the driver's set-up
    window: dict = dataclasses.field(default_factory=dict)   # what the window recorded
    trace: dict | None = None                                # timing.reduce of the traced stretch
    setup_s: float = 0.0
    notes: list = dataclasses.field(default_factory=list)    # readings for standard error


def build_program(cfg: dict):
    """The program of ``cfg``: a frontend, or a frontend and a dense head."""
    from repro_torch import fpca

    spec = fpca.FPCASpec(
        image_h=cfg["image_h"], image_w=cfg["image_w"], out_channels=cfg["out_channels"], kernel=cfg["kernel"],
        stride=cfg["stride"], max_kernel=cfg["max_kernel"], in_channels=cfg["in_channels"],
        padding=cfg["padding"], binning=cfg["binning"], skip_block=cfg["skip_block"],
    )
    gate = fpca.DeltaGateConfig(**cfg["gate"]) if cfg.get("gate") else None
    frontend = fpca.FPCAProgram(
        spec=spec, circuit=fpca.CircuitParams(**cfg["circuit"]),
        adc=fpca.ADCConfig(bits=cfg["adc_bits"], v_ref=cfg["adc_v_ref"]),
        enc=fpca.WeightEncoding(n_levels=cfg["nvm_levels"], w_scale=cfg["w_scale"]), gate=gate,
    )
    if not cfg["head"]:
        return frontend
    head = tuple(fpca.DenseSpec(layer["features"], activation=layer["activation"]) for layer in cfg["head"])
    return fpca.FPCAModelProgram(frontend=frontend, head=head, input_scale=cfg["input_scale"])


def make_weights(cfg: dict, generator: torch.Generator, device: torch.device) -> dict:
    """The NVM kernel ``(c_o, k, k, c_i)``, BN offsets and head layers, drawn
    on ``device`` from ``generator``."""
    w = cfg["weights"]
    c, k = cfg["out_channels"], cfg["kernel"]
    out = {
        "kernel": torch.randn((c, k, k, cfg["in_channels"]), generator=generator, device=device) * w["kernel_std"],
        "bn_offset": torch.randint(0, w["bn_offset_max"], (c,), generator=generator, device=device).float(),
        "head": [],
    }
    d = roofline.geometry(cfg)["counts"]
    for layer in cfg["head"]:
        f = layer["features"]
        out["head"].append({
            "w": torch.randn((d, f), generator=generator, device=device) * d ** -0.5,
            "b": torch.randn((f,), generator=generator, device=device) * w["head_bias_std"],
        })
        d = f
    return out


def compile_handle(ctx: Ctx):
    """``fpca.compile`` of the configuration on the run's device, with the
    run's calibration and weights and the mix's handle settings."""
    from repro_torch import fpca
    from repro_torch.core.curvefit import BucketCurvefitModel

    w = ctx.weights
    kw: dict[str, Any] = dict(ctx.traffic.get("handle", {}))
    if ctx.cfg["head"]:
        kw["head_params"] = [dict(layer) for layer in w["head"]]
    return fpca.compile(
        build_program(ctx.cfg), device=ctx.device, model=BucketCurvefitModel.from_dict(ctx.calib),
        weights=w["kernel"], bn_offset=w["bn_offset"], **kw,
    )


def card_state() -> str:
    """The card's SM clock, temperature and power as ``nvidia-smi`` reads
    them, for the run's notes (empty where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(seed) % (1 << 63))


def run_cell(workload: str, cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
             device: torch.device, metrics: list[str], t_start: float | None = None,
             control: str | None = None, notes: list[str] | None = None) -> dict:
    """Run the cell once; returns the result line's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``checks`` last) and ``lines``: the readings for standard
    error (``notes`` first), each compared number beside its limit last."""
    t_start = time.perf_counter() if t_start is None else t_start
    drv = layout.driver(traffic["driver"])
    t0 = time.perf_counter()
    calib = calibration.cached(cfg, CACHE / "calibration")
    t1 = time.perf_counter()
    gen = generator(seed, device)
    ctx = Ctx(workload=workload, cfg=cfg, traffic=traffic, seed=seed, device=device, calib=calib,
              weights=make_weights(cfg, gen, device), notes=list(notes or []))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t2 = time.perf_counter()
    ctx.notes.append(f"setup: calibration {t1 - t0!r} s, weights {t2 - t1!r} s, {t2 - t_start!r} s in all")
    drv.setup(ctx, gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.setup_s = time.perf_counter() - t_start
    ctx.notes.append(f"card before the window: {card_state()}")
    drv.window(ctx, seconds, trace)
    ctx.notes.append(f"card after the window: {card_state()}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if ctx.window.get("profile") is not None:
        ctx.trace = reduce_trace(ctx.window.pop("profile"))
    ctx.state.pop("handle")              # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed, lines = drv.check(ctx, control)
    ctx.notes.append(f"check_s {time.perf_counter() - t_check!r}")
    correct, checks = compare.judge(numbers, cfg["limits"])
    values = {}
    for name in metrics:
        v = layout.metric_reader(name)(ctx)
        if v is not None:
            values[name] = v
    bench = layout.benchmark()
    spec = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    result: dict = {
        "correct": bool(correct),
        "attempted": int(ctx.window["attempted"]),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": spec[k]["unit"]} for k, v in values.items()},
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = ctx.trace["breakdown"]
    result["checks"] = checks
    lat = ctx.window.get("latency_ms") or [0.0]
    q = np.percentile(np.asarray(lat), [5, 50, 95, 99, 100])
    lines = list(lines) + [f"setup_s {ctx.setup_s!r}", f"memory_peak_bytes {peak!r}",
                           "latency ms p5 p50 p95 p99 max " + " ".join(repr(float(v)) for v in q)] + ctx.notes
    lines += [f"{k} {v!r}" for k, v in values.items()]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    result["lines"] = lines
    return result
