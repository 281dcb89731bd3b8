"""Model zoo: the architecture registry (``register_arch`` / ``build_model``).

An architecture is a named builder ``fn(cfg) -> FPCAModelProgram``;
``build_model({"arch": name, ...})`` dispatches to it and stamps the
program with ``arch=name`` (a label, outside the signature).  Three ship
registered:

* ``"fpca_cnn"``    — the sequential classifier of
  :mod:`repro_torch.configs.fpca_cnn`, built from the same head tuple, so
  its signature is the config module's and both share every executable;
* ``"fpca_resnet"`` — a residual classifier over a
  :class:`repro_torch.models.heads.HeadGraph` (SAME-conv stem, two-conv
  branch, post-add relu join, avg-pool, two dense stages);
* ``"fpca_detect"`` — a detection head: per-cell class scores and 4 box
  channels (:class:`repro_torch.models.heads.DetectSpec`).

``cfg`` keys every builder understands: ``spec`` (an
:class:`repro_torch.core.mapping.FPCASpec` or kwargs mapping; default
``repro_torch.configs.fpca_cnn.FRONTEND_SPEC``), ``frontend`` (a full
:class:`FPCAProgram`, or extra ``FPCAProgram`` kwargs), ``input_scale``,
``n_classes``; per-arch knobs are documented on each builder.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from repro_torch.core.mapping import FPCASpec
from repro_torch.fpca.program import ConvSpec, DenseSpec, FPCAModelProgram, FPCAProgram, PoolSpec
from repro_torch.models.heads import AddSpec, DetectSpec, HeadGraph, Node

__all__ = ["register_arch", "build_model", "available_archs"]

_ARCHS: dict[str, Callable[[Mapping], FPCAModelProgram]] = {}


def register_arch(name: str, *, overwrite: bool = False):
    """Decorator registering a builder ``fn(cfg) -> FPCAModelProgram`` under
    ``name``.  A duplicate name is an error unless ``overwrite=True``."""
    if not name or not isinstance(name, str):
        raise ValueError("architecture name must be a non-empty string")

    def deco(fn: Callable[[Mapping], FPCAModelProgram]):
        if name in _ARCHS and not overwrite:
            raise ValueError(f"architecture {name!r} already registered; pass overwrite=True to replace it")
        _ARCHS[name] = fn
        return fn

    return deco


def available_archs() -> tuple[str, ...]:
    """Registered architecture names, sorted."""
    return tuple(sorted(_ARCHS))


def build_model(cfg: Mapping | None = None, **overrides) -> FPCAModelProgram:
    """Build the architecture named by ``cfg["arch"]`` (keyword arguments
    override cfg keys), stamped with ``arch=name``."""
    merged: dict[str, Any] = {**(dict(cfg) if cfg else {}), **overrides}
    if "arch" not in merged:
        raise KeyError("build_model(cfg) needs an 'arch' key naming a registered architecture")
    name = merged["arch"]
    builder = _ARCHS.get(name)
    if builder is None:
        raise KeyError(f"unknown architecture {name!r}; registered: {list(available_archs())}")
    model = builder(merged)
    if model.arch != name:
        model = model.replace(arch=name)
    return model


def _frontend(cfg: Mapping) -> FPCAProgram:
    fe = cfg.get("frontend")
    if isinstance(fe, FPCAProgram):
        return fe
    spec = cfg.get("spec")
    if spec is None:
        from repro_torch.configs.fpca_cnn import FRONTEND_SPEC

        spec = FRONTEND_SPEC
    if isinstance(spec, Mapping):
        spec = FPCASpec(**spec)
    kw = dict(fe) if isinstance(fe, Mapping) else {}
    return FPCAProgram(spec=spec, **kw)


# ---------------------------------------------------------------------------
# Registered architectures
# ---------------------------------------------------------------------------

@register_arch("fpca_cnn")
def _build_fpca_cnn(cfg: Mapping) -> FPCAModelProgram:
    """The sequential classifier.  Knobs: ``hidden`` (dense width),
    ``n_classes``, or a full ``head`` tuple; the default equals
    ``repro_torch.configs.fpca_cnn.HEAD``."""
    from repro_torch.configs import fpca_cnn as defaults

    head = cfg.get("head")
    if head is None:
        hidden = int(cfg.get("hidden", defaults.N_HIDDEN))
        n_classes = int(cfg.get("n_classes", defaults.N_CLASSES))
        head = (DenseSpec(hidden, activation="relu"), DenseSpec(n_classes))
    return FPCAModelProgram(
        frontend=_frontend(cfg), head=tuple(head), input_scale=float(cfg.get("input_scale", 1.0))
    )


@register_arch("fpca_resnet")
def _build_fpca_resnet(cfg: Mapping) -> FPCAModelProgram:
    """Residual classifier.  Knobs: ``width`` (conv channels, 16),
    ``hidden`` (32), ``n_classes`` (2)."""
    width = int(cfg.get("width", 16))
    hidden = int(cfg.get("hidden", 32))
    n_classes = int(cfg.get("n_classes", 2))
    graph = HeadGraph(
        nodes=(
            Node("stem", ConvSpec(width, 3, padding="SAME"), ("input",)),
            Node("conv1", ConvSpec(width, 3, padding="SAME"), ("stem",)),
            Node("conv2", ConvSpec(width, 3, padding="SAME", activation=None), ("conv1",)),
            Node("join", AddSpec(activation="relu"), ("stem", "conv2")),
            Node("pool", PoolSpec(2, kind="avg"), ("join",)),
            Node("fc", DenseSpec(hidden, activation="relu"), ("pool",)),
            Node("logits", DenseSpec(n_classes), ("fc",)),
        ),
        output="logits",
    )
    return FPCAModelProgram(frontend=_frontend(cfg), head=graph, input_scale=float(cfg.get("input_scale", 1.0)))


@register_arch("fpca_detect")
def _build_fpca_detect(cfg: Mapping) -> FPCAModelProgram:
    """Detection head: a SAME-conv trunk, then a :class:`DetectSpec` with
    ``n_classes`` scores and 4 box channels per cell of the frontend grid.
    Knobs: ``width`` (trunk channels, 16), ``n_classes`` (2),
    ``detect_kernel`` (1)."""
    width = int(cfg.get("width", 16))
    n_classes = int(cfg.get("n_classes", 2))
    graph = HeadGraph(
        nodes=(
            Node("trunk", ConvSpec(width, 3, padding="SAME"), ("input",)),
            Node("det", DetectSpec(n_classes, kernel=int(cfg.get("detect_kernel", 1))), ("trunk",)),
        ),
        output="det",
    )
    return FPCAModelProgram(frontend=_frontend(cfg), head=graph, input_scale=float(cfg.get("input_scale", 1.0)))
