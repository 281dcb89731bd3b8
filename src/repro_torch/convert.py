"""Bring state of the reference package, handed over as numpy, into the port.

The reference's objects export plain numpy (``BucketCurvefitModel.to_dict()``,
``np.asarray`` of its parameter arrays), so the port never imports it:

    model = bucket_model_from_dict(ref_model.to_dict())
    head = head_params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                                   for p in ref_head_params])    # chain head
    graph = head_params_from_numpy({n: {k: np.asarray(v) for k, v in p.items()}
                                    for n, p in ref_graph_params.items()})
    kernel = tensor_from_numpy(np.asarray(ref_kernel))   # on the card by default
    frontend = frontend_params_from_numpy({k: np.asarray(v) for k, v in
                                           ref_frontend_params.items()})
    lm = lm_params_from_numpy(jax.tree.map(np.asarray, ref_lm_params))
    opt = adamw_state_from_numpy(*jax.tree.map(np.asarray, tuple(ref_adamw_state)))
    st = segment_state_from_numpy(**{k: np.asarray(v) for k, v in
                                     dataclasses.asdict(ref_seg.state).items()})

Both sides then compute on the same numbers; random streams are never
compared.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core.curvefit import BucketCurvefitModel
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamWState

__all__ = [
    "adamw_state_from_numpy",
    "bucket_model_from_dict",
    "frontend_params_from_numpy",
    "head_params_from_numpy",
    "lm_params_from_numpy",
    "segment_state_from_numpy",
    "tensor_from_numpy",
]


def bucket_model_from_dict(d: dict) -> BucketCurvefitModel:
    """A fitted bucket model from the reference's ``to_dict()``."""
    return BucketCurvefitModel.from_dict(d)


def tensor_from_numpy(a: Any, *, device: str | torch.device | None = None) -> torch.Tensor:
    """A float32 tensor (NVM kernel, BN offsets, images) on ``device`` (the
    card by default)."""
    return torch.tensor(np.asarray(a, np.float32), device=resolve_device(device))


def frontend_params_from_numpy(
    d: dict, *, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """An ``FPCAFrontend``'s parameters from the reference layer's ``init``
    dict: ``{"kernel": (c_o, k, k, c_i), "bn_offset": (c_o,)}``, float32 on
    ``device`` (the card by default)."""
    return {k: tensor_from_numpy(d[k], device=device) for k in ("kernel", "bn_offset")}


def head_params_from_numpy(
    params: Iterable[dict] | dict, *, device: str | torch.device | None = None
) -> list[dict[str, torch.Tensor]] | dict[str, dict[str, torch.Tensor]]:
    """Head parameters with the reference's layouts kept: ``(d_in, d_out)``
    dense and ``(c_out, k, k, c_in)`` conv weights.  A chain head is one
    dict per stage (``{}`` for parameterless stages), a graph head a dict
    keyed by node name.  Quantised stages (``w_q``, ``w_scale``, ``b``,
    ``x_scale``) keep ``w_q`` int8; every other leaf becomes float32."""
    dev = resolve_device(device)

    def stage(p: dict) -> dict[str, torch.Tensor]:
        out = {}
        for k, v in dict(p).items():
            a = np.asarray(v)
            out[k] = (torch.tensor(a, dtype=torch.int8, device=dev) if a.dtype == np.int8
                      else tensor_from_numpy(a, device=dev))
        return out

    if isinstance(params, dict):
        return {name: stage(p) for name, p in params.items()}
    return [stage(p) for p in params]


def _leaf_from_numpy(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def lm_params_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """A language model's params from the reference's ``init_model`` pytree
    given as nested dicts of numpy arrays.  The port keeps the reference's
    layout and dtypes, so this is a leaf-by-leaf copy: for the hybrid
    family ``mamba_main`` leaves stay stacked ``(n_groups, period, ...)``,
    ``mamba_tail`` leaves ``(n_tail, ...)``, and ``shared_attn`` is one
    block."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_from_numpy(node, dev)

    return conv(tree)


def adamw_state_from_numpy(
    step: Any, mu: dict, nu: dict, *, device: str | torch.device | None = None
) -> AdamWState:
    """The reference's ``AdamWState(step, mu, nu)`` with numpy leaves: the
    step as a host int32 scalar, the f32 moments copied leaf by leaf onto
    ``device`` (the card by default) in the params' layout."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
        mu=lm_params_from_numpy(mu, device=dev),
        nu=lm_params_from_numpy(nu, device=dev),
    )


def segment_state_from_numpy(
    has_prev: Any,
    prev_eff: Any,
    age: Any,
    frame_idx: Any,
    eff: Any | None = None,
    logits: Any | None = None,
    suggested_bucket: int | None = None,
    *,
    device: str | torch.device | None = None,
):
    """A :class:`repro_torch.fpca.SegmentState` from the reference's
    ``SegmentState`` fields as numpy, on ``device`` (the card by default),
    so a stream the reference served can continue in the port: the gate
    carry (``bool``, float32, int32, int32) and, for model segments, the
    effective map and previous logits (float32)."""
    from repro_torch.fpca.executable import SegmentState

    dev = resolve_device(device)

    def t(a: Any, dtype: torch.dtype) -> torch.Tensor | None:
        return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return SegmentState(
        has_prev=t(has_prev, torch.bool),
        prev_eff=t(prev_eff, torch.float32),
        age=t(age, torch.int32),
        frame_idx=t(frame_idx, torch.int32),
        eff=t(eff, torch.float32),
        logits=t(logits, torch.float32),
        suggested_bucket=None if suggested_bucket is None else int(suggested_bucket),
    )
