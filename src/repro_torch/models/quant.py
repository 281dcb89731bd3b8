"""Quantised int8 lowering for digital heads, and the symmetric int8 leaf
numerics.

Selected with ``FPCAModelProgram(precision="int8")``; the numerics are the
reference package's:

* **weights**: per-out-channel symmetric scales ``s_w[c] = max|w[..., c]| /
  127``, ``w_q = clip(round(w / s_w), -127, 127)``;
* **activations**: one symmetric scale per parameterized stage, calibrated
  from an f32 forward pass over sample counts (``s_x = max|x| / 127``),
  requantised at every stage input;
* **accumulation**: exact int8 x int8 -> int32 on integer-valued f32
  carriers.  Each partial sum reduces at most :data:`_CHUNK` = 1024 terms,
  so it stays below ``1024 * 127 * 127 < 2**24`` and is exact in f32 in any
  summation order; partials are cast to int32 between chunks.  Convolutions
  are lowered as im2col (a strided window view with XLA's SAME pads) plus
  the same chunked matmul, never through ``F.conv2d``: cuDNN may pick a
  Winograd or FFT algorithm whose transforms are not exact on integer
  carriers.  The
  f32 matmuls must run in IEEE f32 (``torch.get_float32_matmul_precision()
  == "highest"``, the default);
* **dequantise**: ``y = acc * (s_x * s_w) + b`` in f32, then the stage
  activation; pooling and joins run in f32 between stages.

``torch.round`` and ``jnp.round`` both round half to even, and
``.to(torch.int32)`` truncates as ``astype(int32)`` does, so the int32
accumulators equal the reference's bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "quantize_symmetric",
    "quantize_leaf_symmetric",
    "dequantize_leaf",
    "quant_bank_dot",
    "linear_int8",
    "conv2d_int8",
    "linear_int8_acc",
    "conv2d_int8_acc",
    "calibrate_head_scales",
    "quantize_head_params",
    "bind_quant_head_params",
    "is_quantized_params",
    "apply_head_int8",
    "pack_act_scales",
    "unpack_act_scales",
    "logit_parity",
]

# Max reduction depth per f32-carrier partial sum: every partial stays below
# 1024 * 127 * 127 = 16 516 096 < 2**24.
_CHUNK = 1024

_QUANT_KEYS = frozenset({"w_q", "w_scale", "b", "x_scale"})


# ---------------------------------------------------------------------------
# leaf numerics
# ---------------------------------------------------------------------------

def quantize_symmetric(
    g: torch.Tensor, channel_axis: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of one tensor: ``(q int8, scale f32)``.

    ``channel_axis=None`` gives one scalar scale; an integer axis gives
    per-channel scales with ``keepdim`` shape."""
    g = g.float()
    if channel_axis is None:
        scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    else:
        red = tuple(i for i in range(g.ndim) if i != channel_axis % g.ndim)
        scale = torch.clamp_min(g.abs().amax(dim=red, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_leaf_symmetric(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantise: ``(q int8, scale f32 scalar)``."""
    return quantize_symmetric(g)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_leaf_symmetric` (f32)."""
    return q.float() * scale


# ---------------------------------------------------------------------------
# exact int8 matmul / conv on f32 carriers
# ---------------------------------------------------------------------------

def quant_bank_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact ``int8 x int8 -> int32`` matmul through f32 GEMMs.

    ``x_q`` is an integer-valued f32 carrier in [-127, 127], shape
    ``(..., K)``; ``w_q`` an int8 ``(K, N)`` plane.  The reduction is cut
    into chunks of at most :data:`_CHUNK` terms, one batched GEMM over the
    chunks; each f32 partial is exact and the chunks sum in int32."""
    K, N = w_q.shape
    wf = w_q.float()
    if K <= _CHUNK:
        return torch.matmul(x_q, wf).to(torch.int32)
    n_chunks = -(-K // _CHUNK)
    pad = n_chunks * _CHUNK - K
    if pad:
        x_q = F.pad(x_q, (0, pad))
        wf = F.pad(wf, (0, 0, 0, pad))
    lead = x_q.shape[:-1]
    xs = x_q.reshape(-1, n_chunks, _CHUNK).transpose(0, 1)         # (n_chunks, M, _CHUNK)
    parts = torch.bmm(xs, wf.reshape(n_chunks, _CHUNK, N))         # (n_chunks, M, N)
    return parts.to(torch.int32).sum(dim=0, dtype=torch.int32).reshape(lead + (N,))


def _requant(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """Quantise an f32 activation to an integer-valued f32 int8 carrier."""
    return torch.clamp(torch.round(x / x_scale), -127.0, 127.0)


def _dequant(acc: torch.Tensor, qp: dict) -> torch.Tensor:
    return acc.float() * (qp["x_scale"] * qp["w_scale"]) + qp["b"]


def linear_int8_acc(qp: dict, x: torch.Tensor) -> torch.Tensor:
    """The int32 accumulators of a quantised dense stage."""
    return quant_bank_dot(_requant(x, qp["x_scale"]), qp["w_q"])


def linear_int8(qp: dict, x: torch.Tensor) -> torch.Tensor:
    """Quantised biased dense stage: requantise -> int32 GEMM -> dequant."""
    return _dequant(linear_int8_acc(qp, x), qp)


def conv2d_int8_acc(qp: dict, x: torch.Tensor, stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """The int32 accumulators ``(b, h_o, w_o, c_out)`` of a quantised NHWC
    convolution (weights ``(c_out, k, k, c_in)`` int8), lowered as im2col
    plus :func:`quant_bank_dot`."""
    from repro_torch.models.layers import _same_pads

    x_q = _requant(x, qp["x_scale"])                               # NHWC carrier
    w = qp["w_q"]
    c_out, k, _, c_in = (int(d) for d in w.shape)
    if padding == "SAME":
        (ht, hb), (wl, wr) = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
        x_q = F.pad(x_q, (0, 0, wl, wr, ht, hb))
    # the windows as a strided view (b, h_o, w_o, c_in, k, k), copied once
    # by the reshape (F.unfold on CUDA launches one im2col kernel per frame)
    win = x_q.unfold(1, k, stride).unfold(2, k, stride)
    b, h_o, w_o = win.shape[:3]
    cols = win.reshape(b, h_o * w_o, c_in * k * k)
    wm = w.permute(3, 1, 2, 0).reshape(c_in * k * k, c_out)        # the same (c, kh, kw) order
    return quant_bank_dot(cols, wm).reshape(b, h_o, w_o, c_out)


def conv2d_int8(qp: dict, x: torch.Tensor, stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """Quantised NHWC convolution: requantise -> int32 im2col GEMM -> dequant."""
    return _dequant(conv2d_int8_acc(qp, x, stride, padding), qp)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _default_calib_counts(program, device) -> torch.Tensor:
    """Data-free calibration input: one full-scale SS-ADC count map (every
    count at ``levels - 1``, the frontend's hard ceiling)."""
    h_o, w_o, c_o = program.frontend.out_shape
    return torch.full((1, h_o, w_o, c_o), float(program.frontend.adc.levels - 1), device=device)


def _scale_of(x: torch.Tensor) -> float:
    return max(float(x.abs().max()), 1e-12) / 127.0


def calibrate_head_scales(program, params: Any, sample_counts: Any) -> Any:
    """Per-stage input activation scales from one f32 forward pass.

    ``params`` is the bound f32 head.  Returns a list aligned with the chain
    stages (``None`` for parameterless ones), or a dict keyed by
    parameterized node name for a graph head; scales are host floats."""
    from repro_torch.fpca.program import _evaluate_chain
    from repro_torch.models.heads import evaluate
    from repro_torch.models.layers import conv2d, linear

    x = torch.as_tensor(sample_counts, dtype=torch.float32)
    if x.ndim == 3:
        x = x[None]
    x = x * float(program.input_scale)
    if program.is_graph_head:
        graph_scales: dict[str, float] = {}
        evaluate(program.head, x, conv=conv2d, linear=linear, params=params,
                 on_stage=lambda name, v: graph_scales.__setitem__(name, _scale_of(v)))
        return graph_scales
    scales: list[float | None] = [None] * len(program.head)
    _evaluate_chain(program.head, x, conv=conv2d, linear=linear, params=params,
                    on_stage=lambda i, v: scales.__setitem__(i, _scale_of(v)))
    return scales


# ---------------------------------------------------------------------------
# head parameter quantisation / binding
# ---------------------------------------------------------------------------

def _quant_stage(p: dict, channel_axis: int, x_scale: float) -> dict:
    w_q, w_scale = quantize_symmetric(p["w"], channel_axis=channel_axis)
    return {
        "w_q": w_q,
        "w_scale": w_scale.reshape(-1).float(),
        "b": p["b"].float(),
        "x_scale": torch.tensor(x_scale, dtype=torch.float32, device=p["w"].device),
    }


def is_quantized_params(params: Any) -> bool:
    """Whether a head tree carries quantised stages (``w_q`` leaves)."""
    if isinstance(params, dict):
        vals = list(params.values())
    else:
        try:
            vals = list(params)
        except TypeError:
            return False
    return any(isinstance(p, dict) and "w_q" in p for p in vals)


def quantize_head_params(
    program,
    params: Any,
    *,
    sample_counts: Any | None = None,
    act_scales: Any | None = None,
    device: str | torch.device | None = None,
) -> Any:
    """Quantise an f32 head tree into the int8 serving tree on ``device``
    (the parameters' own when None).

    ``act_scales`` (from :func:`calibrate_head_scales`, or
    :func:`unpack_act_scales`) take precedence; otherwise the scales are
    calibrated on ``sample_counts``, else on the data-free full-scale count
    map.  The result has one ``{"w_q", "w_scale", "b", "x_scale"}`` dict
    per parameterized stage."""
    from repro_torch.fpca.program import ConvSpec, DenseSpec
    from repro_torch.models.heads import DetectSpec

    bound = program._bind_f32(params, device=device)
    if act_scales is None:
        dev = (next(iter(bound.values())) if program.is_graph_head else
               next(p for p in bound if p))["w"].device
        if sample_counts is None:
            sample_counts = _default_calib_counts(program, dev)
        act_scales = calibrate_head_scales(program, bound, torch.as_tensor(sample_counts, device=dev))
    if program.is_graph_head:
        out: dict[str, dict] = {}
        for node in program.head._param_nodes():
            axis = 0 if isinstance(node.op, (ConvSpec, DetectSpec)) else 1
            out[node.name] = _quant_stage(bound[node.name], axis, act_scales[node.name])
        return out
    staged: list[dict] = []
    for layer, p, s in zip(program.head, bound, act_scales):
        if isinstance(layer, ConvSpec):
            staged.append(_quant_stage(p, 0, s))
        elif isinstance(layer, DenseSpec):
            staged.append(_quant_stage(p, 1, s))
        else:
            staged.append({})
    return staged


def _bind_quant_stage(p: Any, want_w: tuple, where: str, device) -> dict:
    from repro_torch.fpca.program import _as_tensor

    p = dict(p)
    if set(p) != set(_QUANT_KEYS):
        raise ValueError(f"{where}: quantised stage needs keys {sorted(_QUANT_KEYS)}, got {sorted(p)}")
    out = {k: _as_tensor(p[k], torch.int8 if k == "w_q" else torch.float32, device)
           for k in ("w_q", "w_scale", "b", "x_scale")}
    c = want_w[0] if len(want_w) == 4 else want_w[1]
    got = {k: tuple(v.shape) for k, v in out.items()}
    want = {"w_q": want_w, "w_scale": (c,), "b": (c,), "x_scale": ()}
    if got != want:
        raise ValueError(f"{where}: quantised parameter shapes {got} do not match expected {want}")
    return out


def bind_quant_head_params(program, params: Any, *, device: str | torch.device | None = None) -> Any:
    """Validate and coerce an int8 head tree onto ``device`` (the
    ``precision="int8"`` counterpart of the f32 binding path)."""
    from repro_torch.fpca.program import ConvSpec, DenseSpec, _dense_in

    if program.is_graph_head:
        if not isinstance(params, dict):
            raise ValueError(
                f"graph head parameters must be a dict keyed by node name, got {type(params).__name__}"
            )
        want_names = {n.name for n in program.head._param_nodes()}
        if set(params) != want_names:
            raise ValueError(
                f"graph head parameters keyed {sorted(params)} do not match parameterized nodes "
                f"{sorted(want_names)}"
            )
        shapes = program.head.shapes(program.frontend.out_shape)
        return {
            node.name: _bind_quant_stage(
                params[node.name], program.head._want_shapes(node, shapes)["w"],
                f"head node {node.name!r}", device,
            )
            for node in program.head._param_nodes()
        }
    bound = list(params)
    if len(bound) != len(program.head):
        raise ValueError(f"head has {len(program.head)} stages but got {len(bound)} parameter entries")
    shapes = program.head_shapes()
    out: list[dict] = []
    for i, (layer, p) in enumerate(zip(program.head, bound)):
        cur = shapes[i]
        if isinstance(layer, ConvSpec):
            want_w: tuple = (layer.out_channels, layer.kernel, layer.kernel, cur[-1])
        elif isinstance(layer, DenseSpec):
            want_w = (_dense_in(cur), layer.features)
        else:
            if p:
                raise ValueError(f"head[{i}] ({type(layer).__name__}): parameterless stage got parameters")
            out.append({})
            continue
        out.append(_bind_quant_stage(p, want_w, f"head[{i}] ({type(layer).__name__})", device))
    return out


# ---------------------------------------------------------------------------
# int8 head apply (the precision="int8" numerics)
# ---------------------------------------------------------------------------

def apply_head_int8(program, params: Any, counts: torch.Tensor) -> torch.Tensor:
    """The int8 counterpart of ``FPCAModelProgram.apply_head``."""
    from repro_torch.fpca.program import _evaluate_chain

    x = torch.as_tensor(counts).float() * float(program.input_scale)
    if program.is_graph_head:
        return _apply_graph_int8(program.head, params, x)
    if len(params) != len(program.head):
        raise ValueError(f"head has {len(program.head)} stages but got {len(params)} parameter entries")
    return _evaluate_chain(program.head, x, conv=conv2d_int8, linear=linear_int8, params=params)


def _apply_graph_int8(graph, params: Any, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.models.heads import evaluate

    if x.ndim == 3:
        return _apply_graph_int8(graph, params, x[None])[0]
    return evaluate(graph, x, conv=conv2d_int8, linear=linear_int8, params=params)


# ---------------------------------------------------------------------------
# export bundle round-trip + parity metrics
# ---------------------------------------------------------------------------

def pack_act_scales(program, act_scales: Any) -> np.ndarray:
    """Flatten calibrated activation scales into one f32 array for an npz
    export bundle (chain: one slot per stage, 0 marking parameterless
    stages; graph: parameterized nodes in definition order)."""
    if program.is_graph_head:
        names = [n.name for n in program.head._param_nodes()]
        return np.asarray([act_scales[n] for n in names], np.float32)
    return np.asarray([0.0 if s is None else float(s) for s in act_scales], np.float32)


def unpack_act_scales(program, arr: Any) -> Any:
    """Inverse of :func:`pack_act_scales`."""
    arr = np.asarray(arr, np.float32).reshape(-1)
    if program.is_graph_head:
        names = [n.name for n in program.head._param_nodes()]
        if arr.size != len(names):
            raise ValueError(f"expected {len(names)} activation scales, got {arr.size}")
        return {n: float(s) for n, s in zip(names, arr)}
    if arr.size != len(program.head):
        raise ValueError(f"expected {len(program.head)} activation scales, got {arr.size}")
    return [None if s == 0.0 else float(s) for s in arr]


def logit_parity(ref: Any, test: Any) -> dict[str, float]:
    """Bounded-parity metrics of an int8 lowering against its f32
    reference: ``max_abs_divergence`` over all outputs and
    ``top1_agreement`` over the trailing class axis (1.0 for single-output
    maps)."""
    ref = np.asarray(ref.detach().cpu() if isinstance(ref, torch.Tensor) else ref, np.float32)
    test = np.asarray(test.detach().cpu() if isinstance(test, torch.Tensor) else test, np.float32)
    if ref.shape != test.shape:
        raise ValueError(f"shape mismatch: reference {ref.shape} vs test {test.shape}")
    max_div = float(np.max(np.abs(ref - test))) if ref.size else 0.0
    if ref.ndim >= 2 and ref.shape[-1] > 1:
        a = np.argmax(ref.reshape(-1, ref.shape[-1]), axis=-1)
        b = np.argmax(test.reshape(-1, test.shape[-1]), axis=-1)
        top1 = float(np.mean(a == b))
    else:
        top1 = 1.0
    return {"max_abs_divergence": max_div, "top1_agreement": top1}
