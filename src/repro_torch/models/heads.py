"""Head graphs: the model-zoo IR for residual, multi-branch and detection
heads behind the FPCA frontend.

A :class:`HeadGraph` is a tuple of named :class:`Node`\\ s, each applying
one op to one or more named inputs (``"input"`` is the frontend's scaled
counts).  It is validated at construction (unique names, defined inputs,
no cycle), its geometry per node against a concrete input shape, and its
signature entries are byte-equal to the reference package's.  Parameters
are a dict keyed by node name (conv / dense / detect nodes only).

Graph-only ops: :class:`AddSpec` (residual join), :class:`ConcatSpec`
(channel concat) and :class:`DetectSpec` (per-cell class scores and box
regression).  A graph whose output is a :class:`DetectSpec` is a detection
head: its raw ``(gh, gw, n_classes + 4)`` maps split into
:class:`Detections`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.fpca.program import (
    ActivationSpec,
    ConvSpec,
    DenseSpec,
    PoolSpec,
    _apply_activation,
    _check_activation,
)

__all__ = [
    "AddSpec",
    "ConcatSpec",
    "DetectSpec",
    "Node",
    "HeadGraph",
    "Detections",
]

# Bump when the meaning of a graph signature entry changes; equal to the
# reference's, so a cache key means the same thing on both sides.
_GRAPH_SIG_VERSION = "repro.fpca.head_graph/1"

#: The implicit source node every graph reads: the frontend's SS-ADC counts
#: (scaled by ``input_scale``).  Reserved: no node may take this name.
INPUT = "input"


@dataclasses.dataclass(frozen=True)
class AddSpec:
    """Elementwise residual join: sums >= 2 same-shape inputs, then an
    optional activation."""

    activation: str | None = None

    def __post_init__(self) -> None:
        _check_activation(self.activation)

    def _sig(self) -> tuple:
        return ("add", self.activation or "")


@dataclasses.dataclass(frozen=True)
class ConcatSpec:
    """Channel-axis concat of >= 2 inputs with matching leading dims."""

    activation: str | None = None

    def __post_init__(self) -> None:
        _check_activation(self.activation)

    def _sig(self) -> tuple:
        return ("concat", self.activation or "")


@dataclasses.dataclass(frozen=True)
class DetectSpec:
    """Per-cell detection output: ``n_classes`` class scores plus 4 box
    channels per spatial cell of its input, a ``kernel`` x ``kernel``
    SAME-padded stride-1 conv emitting ``(gh, gw, n_classes + 4)`` raw maps."""

    n_classes: int
    kernel: int = 1

    def __post_init__(self) -> None:
        if self.n_classes < 1:
            raise ValueError("detect n_classes must be >= 1")
        if self.kernel < 1:
            raise ValueError("detect kernel must be >= 1")

    @property
    def out_channels(self) -> int:
        return int(self.n_classes) + 4

    def _sig(self) -> tuple:
        return ("detect", int(self.n_classes), int(self.kernel))


_CHAIN_OPS = (ConvSpec, PoolSpec, DenseSpec, ActivationSpec)
_JOIN_OPS = (AddSpec, ConcatSpec)
_PARAM_OPS = (ConvSpec, DenseSpec, DetectSpec)
_ALL_OPS = _CHAIN_OPS + _JOIN_OPS + (DetectSpec,)


@dataclasses.dataclass(frozen=True)
class Node:
    """One named graph stage: ``op`` applied to the values of ``inputs``.
    Join ops take >= 2 inputs, every other op exactly one."""

    name: str
    op: Any
    inputs: tuple[str, ...] = (INPUT,)

    def __post_init__(self) -> None:
        object.__setattr__(self, "inputs", tuple(self.inputs))
        if not self.name or not isinstance(self.name, str):
            raise ValueError("node name must be a non-empty string")
        if not isinstance(self.op, _ALL_OPS):
            raise TypeError(f"unknown head graph op {self.op!r}")
        if isinstance(self.op, _JOIN_OPS):
            if len(self.inputs) < 2:
                kind = "add" if isinstance(self.op, AddSpec) else "concat"
                raise ValueError(
                    f"node {self.name!r}: {kind} needs at least 2 inputs, got {len(self.inputs)}"
                )
        elif len(self.inputs) != 1:
            raise ValueError(
                f"node {self.name!r}: {type(self.op).__name__} takes exactly 1 input, "
                f"got {len(self.inputs)}"
            )

    def _sig(self) -> tuple:
        return ("node", self.name, self.inputs, self.op._sig())


def _chain_out_shape(op: Any, cur: tuple[int, ...], where: str) -> tuple:
    """Output shape of one single-input op, with node-named errors."""
    if isinstance(op, (ConvSpec, DetectSpec, PoolSpec)) and len(cur) != 3:
        kind = {ConvSpec: "conv", DetectSpec: "detect", PoolSpec: "pool"}[type(op)]
        raise ValueError(f"{where}: {kind} needs a spatial (h, w, c) input, got shape {cur}")
    if isinstance(op, ConvSpec):
        h, w, _ = cur
        if op.padding == "SAME":
            return (-(-h // op.stride), -(-w // op.stride), op.out_channels)
        if op.kernel > h or op.kernel > w:
            raise ValueError(f"{where}: conv kernel {op.kernel} exceeds input {h}x{w}")
        return ((h - op.kernel) // op.stride + 1, (w - op.kernel) // op.stride + 1, op.out_channels)
    if isinstance(op, DetectSpec):
        return (cur[0], cur[1], op.out_channels)
    if isinstance(op, PoolSpec):
        h, w, c = cur
        if op.size > h or op.size > w:
            raise ValueError(f"{where}: pool size {op.size} exceeds input {h}x{w}")
        s = op.size if op.stride is None else op.stride
        return ((h - op.size) // s + 1, (w - op.size) // s + 1, c)
    if isinstance(op, DenseSpec):
        return (op.features,)
    return tuple(cur)                       # ActivationSpec: shape-preserving


@dataclasses.dataclass(frozen=True)
class HeadGraph:
    """A validated DAG of head stages, the graph form of a chain head.

    Construction validates names, references, arity and acyclicity;
    :meth:`shapes` validates geometry against the frontend's ``out_shape``.
    The output node is a :class:`DenseSpec` (logits) or a
    :class:`DetectSpec` (per-cell detections).
    """

    nodes: tuple
    output: str

    def __post_init__(self) -> None:
        object.__setattr__(self, "nodes", tuple(self.nodes))
        if not self.nodes:
            raise ValueError("HeadGraph needs at least one node")
        for n in self.nodes:
            if not isinstance(n, Node):
                raise TypeError(f"HeadGraph nodes must be Node instances, got {n!r}")
        seen: set[str] = set()
        for n in self.nodes:
            if n.name == INPUT:
                raise ValueError(f"node name {INPUT!r} is reserved for the graph input")
            if n.name in seen:
                raise ValueError(f"duplicate node name {n.name!r} in HeadGraph")
            seen.add(n.name)
        for n in self.nodes:
            for ref in n.inputs:
                if ref != INPUT and ref not in seen:
                    raise ValueError(f"node {n.name!r} reads undefined input {ref!r}")
        if self.output not in seen:
            raise ValueError(f"output {self.output!r} is not a node in the graph")
        if not isinstance(self._out_op, (DenseSpec, DetectSpec)):
            raise ValueError(
                "the graph output must be a DenseSpec (logits) or DetectSpec (detections) node"
            )
        self.toposort()                     # raises on cycles

    # -- structure -----------------------------------------------------------
    @property
    def _by_name(self) -> dict[str, Node]:
        by = self.__dict__.get("_by_name_cache")
        if by is None:
            by = {n.name: n for n in self.nodes}
            object.__setattr__(self, "_by_name_cache", by)
        return by

    @property
    def _out_op(self) -> Any:
        return self._by_name[self.output].op

    def toposort(self) -> tuple[Node, ...]:
        """Evaluation order (Kahn), deterministic by definition order."""
        order = self.__dict__.get("_topo_cache")
        if order is not None:
            return order
        deps = {n.name: {r for r in n.inputs if r != INPUT} for n in self.nodes}
        done: set[str] = set()
        out: list[Node] = []
        while len(done) < len(self.nodes):
            ready = [n for n in self.nodes if n.name not in done and not (deps[n.name] - done)]
            if not ready:
                raise ValueError(f"HeadGraph has a cycle through nodes {sorted(set(deps) - done)}")
            for n in ready:
                done.add(n.name)
                out.append(n)
        order = tuple(out)
        object.__setattr__(self, "_topo_cache", order)
        return order

    # -- geometry ------------------------------------------------------------
    def shapes(self, in_shape: tuple[int, ...]) -> dict[str, tuple[int, ...]]:
        """Per-node output shapes for a concrete input shape."""
        shapes: dict[str, tuple[int, ...]] = {INPUT: tuple(int(d) for d in in_shape)}
        for node in self.toposort():
            ins = [shapes[r] for r in node.inputs]
            op = node.op
            if isinstance(op, AddSpec):
                for s in ins[1:]:
                    if s != ins[0]:
                        raise ValueError(
                            f"node {node.name!r}: residual add needs matching input shapes, "
                            f"got {ins[0]} vs {s}"
                        )
                shapes[node.name] = ins[0]
            elif isinstance(op, ConcatSpec):
                lead = ins[0][:-1]
                for s in ins[1:]:
                    if len(s) != len(ins[0]) or s[:-1] != lead:
                        raise ValueError(
                            f"node {node.name!r}: concat needs matching leading dims, "
                            f"got {ins[0]} vs {s}"
                        )
                shapes[node.name] = lead + (sum(s[-1] for s in ins),)
            else:
                shapes[node.name] = _chain_out_shape(op, ins[0], f"node {node.name!r}")
        return shapes

    def out_shape(self, in_shape: tuple[int, ...]) -> tuple[int, ...]:
        return self.shapes(in_shape)[self.output]

    @property
    def output_kind(self) -> str:
        return "detections" if isinstance(self._out_op, DetectSpec) else "logits"

    @property
    def n_classes(self) -> int:
        op = self._out_op
        return int(op.n_classes if isinstance(op, DetectSpec) else op.features)

    # -- identity ------------------------------------------------------------
    def _sig_entries(self) -> tuple:
        """Versioned primitive entries for the model signature: node names,
        wiring and op specs; parameters are not compiled in."""
        return (
            (_GRAPH_SIG_VERSION,)
            + tuple(n._sig() for n in self.nodes)
            + (("output", self.output),)
        )

    # -- parameters ----------------------------------------------------------
    def _param_nodes(self) -> list[Node]:
        return [n for n in self.nodes if isinstance(n.op, _PARAM_OPS)]

    def _want_shapes(self, node: Node, shapes: dict[str, tuple[int, ...]]) -> dict[str, tuple[int, ...]]:
        op, cur = node.op, shapes[node.inputs[0]]
        if isinstance(op, (ConvSpec, DetectSpec)):
            c_out = op.out_channels
            return {"w": (c_out, op.kernel, op.kernel, cur[-1]), "b": (c_out,)}
        return {"w": (int(np.prod(cur)), op.features), "b": (op.features,)}

    def init(
        self,
        generator: torch.Generator | None,
        in_shape: tuple[int, ...],
        *,
        device: str | torch.device | None = None,
    ) -> dict:
        """Fresh parameters ``{node_name: {"w": ..., "b": ...}}`` for the
        parameterized nodes, drawn in node order from the CPU ``generator``."""
        from repro_torch.models.layers import init_conv2d, init_linear

        shapes = self.shapes(in_shape)
        params: dict[str, dict] = {}
        for node in self._param_nodes():
            want = self._want_shapes(node, shapes)["w"]
            if isinstance(node.op, (ConvSpec, DetectSpec)):
                c_out, k, _, c_in = want
                params[node.name] = init_conv2d(c_in, c_out, k, generator=generator, device=device)
            else:
                params[node.name] = init_linear(*want, generator=generator, device=device)
        return params

    def bind(
        self, params: Any, in_shape: tuple[int, ...], *, device: str | torch.device | None = None
    ) -> dict:
        """Validate and coerce a graph parameter dict to float32 tensors on
        ``device`` (their own device when None)."""
        if not isinstance(params, dict):
            raise ValueError(
                f"graph head parameters must be a dict keyed by node name, got {type(params).__name__}"
            )
        from repro_torch.fpca.program import _as_f32_stage

        bound = {name: _as_f32_stage(p, device) for name, p in params.items()}
        want_names = {n.name for n in self._param_nodes()}
        if set(bound) != want_names:
            raise ValueError(
                f"graph head parameters keyed {sorted(bound)} do not match parameterized nodes "
                f"{sorted(want_names)}"
            )
        shapes = self.shapes(in_shape)
        for node in self._param_nodes():
            want = self._want_shapes(node, shapes)
            got = {k: tuple(v.shape) for k, v in bound[node.name].items()}
            if got != want:
                raise ValueError(
                    f"head node {node.name!r} ({type(node.op).__name__}): parameter shapes {got} "
                    f"do not match expected {want}"
                )
        return bound

    def apply(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        """Evaluate the graph on ``(b, h, w, c)``; an unbatched ``(h, w, c)``
        map is accepted too."""
        if x.ndim == 3:
            return self.apply(params, x[None])[0]
        return evaluate(self, x, conv=_conv_f32, linear=_linear_f32, params=params)


def _conv_f32(p: dict, x: torch.Tensor, stride: int, padding: str) -> torch.Tensor:
    from repro_torch.models.layers import conv2d

    return conv2d(p, x, stride, padding)


def _linear_f32(p: dict, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.models.layers import linear

    return linear(p, x)


def evaluate(graph: HeadGraph, x: torch.Tensor, *, conv, linear, params: Any, on_stage=None) -> torch.Tensor:
    """Walk ``graph`` in topological order from input ``x``.  ``conv(p, x,
    stride, padding)`` and ``linear(p, x)`` lower the parameterized ops
    (f32 or int8); ``on_stage(name, x)``, when given, sees each
    parameterized node's input before it runs (calibration)."""
    from repro_torch.models.layers import avg_pool2d, max_pool2d

    values: dict[str, torch.Tensor] = {INPUT: x}
    for node in graph.toposort():
        op = node.op
        ins = [values[r] for r in node.inputs]
        if isinstance(op, ConvSpec):
            if on_stage is not None:
                on_stage(node.name, ins[0])
            y = _apply_activation(op.activation, conv(params[node.name], ins[0], op.stride, op.padding))
        elif isinstance(op, DetectSpec):
            if on_stage is not None:
                on_stage(node.name, ins[0])
            y = conv(params[node.name], ins[0], 1, "SAME")
        elif isinstance(op, PoolSpec):
            pool = max_pool2d if op.kind == "max" else avg_pool2d
            y = pool(ins[0], op.size, op.stride)
        elif isinstance(op, DenseSpec):
            v = ins[0]
            if v.ndim > 2:
                v = v.reshape(v.shape[0], -1)
            if on_stage is not None:
                on_stage(node.name, v)
            y = _apply_activation(op.activation, linear(params[node.name], v))
        elif isinstance(op, AddSpec):
            y = ins[0]
            for v in ins[1:]:
                y = y + v
            y = _apply_activation(op.activation, y)
        elif isinstance(op, ConcatSpec):
            y = _apply_activation(op.activation, torch.cat(ins, dim=-1))
        else:                               # ActivationSpec
            y = _apply_activation(op.fn, ins[0])
        values[node.name] = y
    return values[graph.output]


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class Detections:
    """Per-cell detections: class ``scores`` ``(..., gh, gw, C)`` and
    ``boxes`` ``(..., gh, gw, 4)``, split from one raw :class:`DetectSpec`
    map.  Holds tensors on their device; :meth:`class_map` and
    :meth:`top_k` realise to the host."""

    scores: Any
    boxes: Any

    @classmethod
    def from_raw(cls, raw, n_classes: int) -> "Detections":
        n = int(n_classes)
        if raw.shape[-1] != n + 4:
            raise ValueError(
                f"raw detection map has {raw.shape[-1]} channels, expected n_classes + 4 = {n + 4}"
            )
        return cls(scores=raw[..., :n], boxes=raw[..., n:])

    @property
    def n_classes(self) -> int:
        return int(self.scores.shape[-1])

    @property
    def grid_shape(self) -> tuple[int, int]:
        return (int(self.scores.shape[-3]), int(self.scores.shape[-2]))

    def class_map(self) -> np.ndarray:
        """Argmax class index per cell, on the host."""
        return np.argmax(_host(self.scores), axis=-1)

    def top_k(self, k: int = 5) -> list[dict]:
        """Best ``k`` cells of an unbatched map by max class score: a list of
        ``{"cell": (gy, gx), "class": int, "score": float, "box": [4]}``."""
        s = _host(self.scores)
        b = _host(self.boxes)
        if s.ndim != 3:
            raise ValueError(f"top_k expects an unbatched (gh, gw, C) detection map, got shape {s.shape}")
        best = s.max(axis=-1)
        cls_idx = s.argmax(axis=-1)
        gw = best.shape[1]
        flat = best.ravel()
        order = np.argsort(flat)[::-1][: int(k)]
        boxes = b.reshape(-1, 4)
        return [
            {
                "cell": (int(i // gw), int(i % gw)),
                "class": int(cls_idx.ravel()[i]),
                "score": float(flat[i]),
                "box": [float(v) for v in boxes[i]],
            }
            for i in order
        ]
