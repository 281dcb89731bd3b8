"""Frontend energy / latency / bandwidth models (paper §5, Eqs. 2--8, Fig. 9),
and the digital head's cost model; numpy only (the port's own copy of the
reference's ``core/analysis.py``).

The constants marked "paper" are taken directly from the paper (TSMC 28nm
simulation + cited IO work); timing constants the paper uses but does not
print (exposure, ADC ramp) are stated assumptions.  The streaming session's
energy report and the gate controller's energy metric read these models.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import mapping

__all__ = [
    "FrontendConstants",
    "DigitalConstants",
    "frontend_energy",
    "frontend_latency",
    "head_flops",
    "head_report",
    "model_streaming_report",
    "streaming_frontend_report",
    "bandwidth_reduction",
    "conventional_cis",
]


@dataclasses.dataclass(frozen=True)
class FrontendConstants:
    e_px: float = 148e-12       # J / convolution read cycle        [paper §5.0.1]
    e_adc: float = 41.9e-12     # J / ADC read                       [paper, Kaiser'23]
    e_io: float = 12.34e-12     # J / bit, LVDS                      [paper, Teja'21]
    b_adc: int = 8              # ADC bit precision                  [paper]
    bw_io: float = 1e9          # bit/s per IO pad                   [paper §5.0.2]
    n_io_pads: int = 24         # IO pads                            [paper §5.0.2]
    raw_bits: int = 12          # raw Bayer bit depth                [paper Eq. 6]
    t_exp: float = 20e-6        # s, exposure per read cycle         [assumption]
    t_adc: float = 1.28e-6      # s, SS ramp: 2^8 counts @ 200 MHz   [assumption]

    @property
    def e_px_unit(self) -> float:
        """Per-pixel share of the 75-pixel convolution read energy, used for
        the conventional-CIS baseline (one pixel read at a time)."""
        return self.e_px / 75.0


# ---------------------------------------------------------------------------
# FPCA frontend (Eqs. 1--5)
# ---------------------------------------------------------------------------


def frontend_energy(
    spec: mapping.FPCASpec,
    const: FrontendConstants = FrontendConstants(),
    block_mask: np.ndarray | None = None,
) -> dict[str, float]:
    """Eq. 2 + Eq. 3: ``E = N_C (e_PX + e_ADC) + E_IO``."""
    n_c = mapping.n_cycles_with_skipping(spec, block_mask)
    h_o, w_o = mapping.output_dims(spec)
    if block_mask is not None:
        active = int(mapping.active_window_mask(spec, block_mask).sum())
    else:
        active = h_o * w_o
    e_io = active * spec.out_channels * const.b_adc * const.e_io
    e_total = n_c * (const.e_px + const.e_adc) + e_io
    return {
        "n_cycles": n_c,
        "e_io": e_io,
        "e_total": e_total,
        "active_windows": active,
    }


def frontend_latency(
    spec: mapping.FPCASpec,
    const: FrontendConstants = FrontendConstants(),
    block_mask: np.ndarray | None = None,
) -> dict[str, float]:
    """Eq. 4 + Eq. 5: per-cycle exposure + ramp + IO; frame rate = 1/T.

    With ``block_mask``, only the cycles that actually fire under region
    skipping (§3.4.5) are counted; per-cycle IO keeps the dense ``w_o``
    window estimate (RS/SW gating is row/phase-granular, the IO bus is not).
    """
    n_c = mapping.n_cycles_with_skipping(spec, block_mask)
    _, w_o = mapping.output_dims(spec)
    t_io = w_o * const.b_adc / (const.bw_io * const.n_io_pads)
    t_total = n_c * (const.t_exp + const.t_adc + t_io)
    # an all-skipped frame fires zero cycles (t_total == 0): the sensor is
    # idle — fps is undefined, not infinite.  None is the zero-work sentinel
    # everywhere (observe.fleet_report, strict-JSON artifacts reject Infinity)
    fps = 1.0 / t_total if t_total > 0 else None
    return {"n_cycles": n_c, "t_io": t_io, "t_total": t_total, "fps": fps}


def streaming_frontend_report(
    spec: mapping.FPCASpec,
    block_masks: list[np.ndarray | None],
    const: FrontendConstants = FrontendConstants(),
) -> dict[str, float]:
    """Aggregate executed-window accounting over a gated frame history.

    Unlike the single-frame models above, this reflects what a streaming
    deployment *actually executed*: each frame's delta-gate mask contributes
    its skipped-cycle energy/latency (Eqs. 2--5 with §3.4.5 gating), and the
    summary reports the effective frame rate and the savings versus a dense
    readout of the same stream.
    """
    if not block_masks:
        raise ValueError("empty mask history")
    dense_e = frontend_energy(spec, const)
    dense_t = frontend_latency(spec, const)
    h_o, w_o = mapping.output_dims(spec)
    e_total = t_total = 0.0
    cycles = windows = 0
    for mask in block_masks:
        e = frontend_energy(spec, const, block_mask=mask)
        t = frontend_latency(spec, const, block_mask=mask)
        e_total += e["e_total"]
        t_total += t["t_total"]
        cycles += e["n_cycles"]
        windows += e["active_windows"]
    n = len(block_masks)
    return {
        "frames": n,
        "executed_cycles": cycles,
        "executed_windows": windows,
        "kept_window_frac": windows / (n * h_o * w_o),
        "e_total": e_total,
        "t_total": t_total,
        # a history of all-skipped frames executes nothing (t_total == 0);
        # fps is undefined (None, the shared zero-work sentinel), not Infinity
        "fps_effective": n / t_total if t_total > 0 else None,
        "energy_vs_dense": e_total / (n * dense_e["e_total"]),
        "latency_vs_dense": t_total / (n * dense_t["t_total"]),
    }


# ---------------------------------------------------------------------------
# Digital CNN head (the backend a model program attaches to the frontend)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DigitalConstants:
    """Edge digital-backend cost model for the CNN head of a model program.

    Representative 28nm edge-DSP numbers (stated assumptions, same posture
    as the timing constants above): per-MAC energy and sustained MAC
    throughput of the digital classifier the FPCA frontend feeds, for both
    the full-precision serving datapath and the quantised int8 lowering
    (``FPCAModelProgram(precision="int8")``).  The int8 datapath of an edge
    MAC array is ~4x cheaper per op and ~4x higher throughput than the
    full-precision one on the same silicon (narrower multipliers, 4-wide
    SIMD lanes).
    """

    e_mac: float = 1.0e-12        # J / MAC, full-precision serving datapath
    macs_per_s: float = 4e9       # sustained MAC/s, full-precision
    e_mac_int8: float = 0.25e-12  # J / MAC, int8 datapath (4-wide SIMD)
    macs_per_s_int8: float = 16e9  # sustained int8 MAC/s


def head_flops(model) -> dict:
    """Per-inference digital-head cost of an
    :class:`repro_torch.fpca.FPCAModelProgram` (one frame through the head).

    Returns per-layer ``(kind, macs, params)`` rows plus totals; pooling and
    activation stages count as element ops, not MACs.

    Zoo :class:`repro_torch.models.heads.HeadGraph` heads are costed per node in
    topological order: Conv/Dense/Detect nodes carry MACs + params (a
    DetectSpec is a SAME conv emitting ``n_classes + 4`` channels),
    Add/Concat joins and activations count as element ops.
    """
    from repro_torch.fpca.program import ConvSpec, DenseSpec, PoolSpec

    if getattr(model, "is_graph_head", False):
        return _graph_head_flops(model)
    shapes = model.head_shapes()
    per_layer: list[dict] = []
    macs = params = elem_ops = 0
    for i, layer in enumerate(model.head):
        cur, nxt = shapes[i], shapes[i + 1]
        if isinstance(layer, ConvSpec):
            k2c = layer.kernel * layer.kernel * cur[-1]
            l_macs = nxt[0] * nxt[1] * nxt[2] * k2c
            l_params = layer.out_channels * (k2c + 1)
            # fused activations cost the same element ops as standalone
            # ActivationSpec stages — two spellings of one head must report
            # one cost
            l_elem = int(np.prod(nxt)) if layer.activation else 0
        elif isinstance(layer, DenseSpec):
            d_in = 1
            for d in cur:
                d_in *= int(d)
            l_macs = d_in * layer.features
            l_params = layer.features * (d_in + 1)
            l_elem = layer.features if layer.activation else 0
        elif isinstance(layer, PoolSpec):
            l_macs = l_params = 0
            l_elem = nxt[0] * nxt[1] * nxt[2] * layer.size * layer.size
        else:                           # ActivationSpec
            l_macs = l_params = 0
            l_elem = int(np.prod(nxt))
        per_layer.append(
            {"layer": type(layer).__name__, "macs": l_macs,
             "params": l_params, "elem_ops": l_elem}
        )
        macs += l_macs
        params += l_params
        elem_ops += l_elem
    return {
        "per_layer": per_layer,
        "macs": macs,
        "flops": 2 * macs,
        "params": params,
        "elem_ops": elem_ops,
    }


def _graph_head_flops(model) -> dict:
    """Per-node cost of a :class:`repro_torch.models.heads.HeadGraph` head."""
    from repro_torch.fpca.program import ConvSpec, DenseSpec, PoolSpec
    from repro_torch.models.heads import AddSpec, ConcatSpec, DetectSpec

    graph = model.head
    shapes = graph.shapes(model.frontend.out_shape)
    per_layer: list[dict] = []
    macs = params = elem_ops = 0
    for node in graph.toposort():
        op = node.op
        cur = shapes[node.inputs[0]]
        nxt = shapes[node.name]
        if isinstance(op, (ConvSpec, DetectSpec)):
            kernel = op.kernel
            k2c = kernel * kernel * cur[-1]
            l_macs = nxt[0] * nxt[1] * nxt[2] * k2c
            l_params = op.out_channels * (k2c + 1)
            act = getattr(op, "activation", None)
            l_elem = int(np.prod(nxt)) if act else 0
        elif isinstance(op, DenseSpec):
            d_in = 1
            for d in cur:
                d_in *= int(d)
            l_macs = d_in * op.features
            l_params = op.features * (d_in + 1)
            l_elem = op.features if op.activation else 0
        elif isinstance(op, PoolSpec):
            l_macs = l_params = 0
            l_elem = nxt[0] * nxt[1] * nxt[2] * op.size * op.size
        elif isinstance(op, (AddSpec, ConcatSpec)):
            l_macs = l_params = 0
            # one element op per joined input element (+ the activation)
            l_elem = sum(int(np.prod(shapes[r])) for r in node.inputs)
            if op.activation:
                l_elem += int(np.prod(nxt))
        else:                           # ActivationSpec
            l_macs = l_params = 0
            l_elem = int(np.prod(nxt))
        per_layer.append(
            {"layer": f"{node.name}:{type(op).__name__}", "macs": l_macs,
             "params": l_params, "elem_ops": l_elem}
        )
        macs += l_macs
        params += l_params
        elem_ops += l_elem
    return {
        "per_layer": per_layer,
        "macs": macs,
        "flops": 2 * macs,
        "params": params,
        "elem_ops": elem_ops,
    }


def head_report(model, digital: DigitalConstants = DigitalConstants()) -> dict:
    """Energy / latency of one frame through the digital head (Eq.-2-style
    accounting for the backend the frontend feeds).

    Reports both precisions side by side (``e_head_f32``/``e_head_int8``,
    same for ``t_``) plus the datapath ratios; the headline ``e_head`` /
    ``t_head`` follow the model program's own ``precision`` so downstream
    aggregates (:func:`model_streaming_report`) account the lowering that
    actually serves.
    """
    fl = head_flops(model)
    ops = fl["macs"] + fl["elem_ops"]
    e_f32, t_f32 = ops * digital.e_mac, ops / digital.macs_per_s
    e_int8, t_int8 = ops * digital.e_mac_int8, ops / digital.macs_per_s_int8
    precision = getattr(model, "precision", "f32")
    e_head, t_head = (e_int8, t_int8) if precision == "int8" else (e_f32, t_f32)
    return {
        **fl,
        "precision": precision,
        "e_head": e_head,
        "t_head": t_head,
        "e_head_f32": e_f32,
        "t_head_f32": t_f32,
        "e_head_int8": e_int8,
        "t_head_int8": t_int8,
        "int8_energy_ratio": e_int8 / e_f32,
        "int8_speedup": t_f32 / t_int8,
    }


def model_streaming_report(
    model,
    block_masks: list[np.ndarray | None],
    const: FrontendConstants = FrontendConstants(),
    digital: DigitalConstants = DigitalConstants(),
) -> dict:
    """Whole-model executed-cost accounting over a gated frame history:
    the frontend's executed-window stats (:func:`streaming_frontend_report`)
    with the digital head's FLOPs / energy / latency next to them.

    The skip-aware serving path runs the head on the *patched* effective
    activation map every tick (class logits per tick), so the head cost is
    dense per frame even when the frontend skips — which is exactly why the
    analog frontend carries the savings story.
    """
    rep = streaming_frontend_report(model.frontend.spec, block_masks, const)
    head = head_report(model, digital)
    n = rep["frames"]
    e_model = rep["e_total"] + n * head["e_head"]
    t_model = rep["t_total"] + n * head["t_head"]
    dense_e = frontend_energy(model.frontend.spec, const)["e_total"] + head["e_head"]
    dense_t = frontend_latency(model.frontend.spec, const)["t_total"] + head["t_head"]
    return {
        **rep,
        "head_macs_per_frame": head["macs"],
        "head_flops_per_frame": head["flops"],
        "head_params": head["params"],
        "e_head_total": n * head["e_head"],
        "t_head_total": n * head["t_head"],
        "e_model_total": e_model,
        "t_model_total": t_model,
        # undefined when zero work executed (None — the zero-work sentinel)
        "model_fps_effective": n / t_model if t_model > 0 else None,
        "model_energy_vs_dense": e_model / (n * dense_e),
        "model_latency_vs_dense": t_model / (n * dense_t),
    }


def bandwidth_reduction(spec: mapping.FPCASpec) -> float:
    """Eq. 6: ``BR = (I / O) * (4/3) * (12 / b_ADC)``."""
    h_o, w_o = mapping.output_dims(spec)
    i_elems = spec.image_h * spec.image_w * spec.in_channels
    o_elems = h_o * w_o * spec.out_channels
    return (i_elems / o_elems) * (4.0 / 3.0) * (12.0 / 8.0)


# ---------------------------------------------------------------------------
# Conventional RGB CIS baseline (the red dotted line of Fig. 9(a))
# ---------------------------------------------------------------------------


def conventional_cis(
    image_h: int, image_w: int, const: FrontendConstants = FrontendConstants()
) -> dict[str, float]:
    """Plain sensor readout: every pixel digitised once, raw Bayer shipped out.

    Rolling shutter with column-parallel ADCs: exposure pipelines with the
    row readout, so frame time ≈ rows x (ramp + row IO).
    """
    n_px = image_h * image_w
    e_total = n_px * (const.e_px_unit + const.e_adc) + n_px * const.raw_bits * const.e_io
    t_row_io = image_w * const.raw_bits / (const.bw_io * const.n_io_pads)
    t_total = image_h * (const.t_adc + t_row_io)
    return {"e_total": e_total, "t_total": t_total, "fps": 1.0 / t_total}
