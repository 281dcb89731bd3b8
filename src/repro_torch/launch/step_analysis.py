"""An op-level step counter, the port of ``repro.launch.hlo_analysis``.

The reference parses optimized HLO text because XLA's
``compiled.cost_analysis()`` counts each ``while`` body once, and a
scanned-layers transformer under-reports by the trip count.  Eager torch
has no while body: a Python loop over layers or microbatches executes
every iteration, so a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
around the step sees each trip's ops and the counts need no multipliers.
:func:`analyze_step` runs a step under such a mode and accumulates, per
rank:

* **dot/conv FLOPs** (2 x prod(result) x contraction size), from
  ``torch.utils.flop_counter``'s formulas for ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions and their backward;
* **collective wire bytes**, with the reference's ring factors
  (:func:`repro_torch.launch.roofline.wire_factor`) and the group size
  read from the process group each collective names; the bytes of groups
  that span more than one host of 8 consecutive ranks are also summed
  apart (``wire_bytes_network``), since they leave NVLink;
* an **HBM-traffic proxy** (``bytes_proxy``): matmul/conv operand + result
  bytes plus collective payloads, the reference's proxy (elementwise chains
  are assumed fused into their contractions);
* ``bytes_all_results``: every op's result bytes x 2, views excluded (a
  diagnostic: eager torch materialises each of them).

**Local, not global, shapes.**  Over DTensors the mode steps aside for
every op that takes a DTensor (it returns ``NotImplemented``), so DTensor
lowers the op to its local computation and its collectives first and the
mode counts those, on each rank's shards.  ``torch.utils.flop_counter``'s
own mode counts the global op instead.  The shape inference DTensor runs
under a fake mode is not counted.

``n_whiles`` and ``unknown_trip_whiles`` are kept for the reference's
record layout and are always 0: there is no loop construct to count, every
trip ran.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["analyze_step", "StepStats", "StepCounter"]

_FUNCOL = torch.ops._c10d_functional
_C10D = torch.ops.c10d

# collective op -> (reference's op name, where the group is in the args)
_COLLECTIVES: dict[Any, str] = {
    _FUNCOL.all_gather_into_tensor: "all-gather",
    _FUNCOL.all_gather_into_tensor_coalesced: "all-gather",
    _FUNCOL.reduce_scatter_tensor: "reduce-scatter",
    _FUNCOL.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _FUNCOL.all_reduce: "all-reduce",
    _FUNCOL.all_reduce_: "all-reduce",
    _FUNCOL.all_reduce_coalesced: "all-reduce",
    _FUNCOL.all_reduce_coalesced_: "all-reduce",
    _FUNCOL.all_to_all_single: "all-to-all",
    _FUNCOL.broadcast: "collective-permute",
    _FUNCOL.broadcast_: "collective-permute",
    _C10D.allreduce_: "all-reduce",
    _C10D.allreduce_coalesced_: "all-reduce",
    _C10D._allgather_base_: "all-gather",
    _C10D.allgather_: "all-gather",
    _C10D.allgather_into_tensor_coalesced_: "all-gather",
    _C10D._reduce_scatter_base_: "reduce-scatter",
    _C10D.reduce_scatter_: "reduce-scatter",
    _C10D.reduce_scatter_tensor_coalesced_: "reduce-scatter",
    _C10D.alltoall_base_: "all-to-all",
    _C10D.alltoall_: "all-to-all",
    _C10D.broadcast_: "collective-permute",
}

_NO_RESULT = {
    torch.ops.aten.detach, torch.ops.aten.alias, torch.ops.aten.lift_fresh,
    torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
    _FUNCOL.wait_tensor,
}


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    bytes_proxy: float = 0.0        # dot/conv operands+results + collectives
    bytes_all_results: float = 0.0  # every materialised result x2 (diagnostic)
    wire_bytes: float = 0.0
    wire_bytes_network: float = 0.0  # the part on groups that span hosts
    collectives: dict = dataclasses.field(default_factory=dict)
    n_whiles: int = 0
    unknown_trip_whiles: int = 0
    n_ops: int = 0                  # ops counted (local ops, collectives included)


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def _group(args: tuple, kwargs: dict):
    """The process group a collective names (by name or object), or None."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a
    return None


def _group_geometry(args: tuple, kwargs: dict, world: int, per_host: int) -> tuple[int, bool]:
    """(group size, whether the group spans more than one host of
    ``per_host`` consecutive ranks)."""
    import torch.distributed as dist

    pg = _group(args, kwargs)
    if pg is None:
        return world, world > per_host
    try:
        ranks = dist.get_process_group_ranks(pg)
    except (ValueError, RuntimeError):
        return pg.size(), pg.size() > per_host
    return len(ranks), len({r // per_host for r in ranks}) > 1


class StepCounter(TorchDispatchMode):
    """Counts the local ops of whatever runs under it into :attr:`stats`."""

    def __init__(self, world: int = 1, per_host: int = 8):
        super().__init__()
        self.world = world
        self.per_host = per_host
        self.stats = StepStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor lower it to local ops first
        out = func(*args, **kwargs)
        fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
        if fake or any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return out                      # DTensor's shape inference, not the step
        packet = getattr(func, "_overloadpacket", None)
        st = self.stats
        st.n_ops += 1
        rbytes = _nbytes(out)
        if packet not in _NO_RESULT and not getattr(func, "is_view", False):
            st.bytes_all_results += 2.0 * rbytes
        if packet in flop_registry:
            st.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
            st.bytes_proxy += _nbytes((args, kwargs)) + rbytes
        elif packet in _COLLECTIVES:
            from repro_torch.launch.roofline import wire_factor

            op = _COLLECTIVES[packet]
            n, spans_hosts = _group_geometry(args, kwargs, self.world, self.per_host)
            # the reference charges the result: the gathered tensor, the
            # scattered shard, the reduced tensor (c10d's in-place ops write
            # their first tensor argument)
            payload = rbytes if packet in (
                _FUNCOL.all_gather_into_tensor, _FUNCOL.all_gather_into_tensor_coalesced,
                _FUNCOL.reduce_scatter_tensor, _FUNCOL.reduce_scatter_tensor_coalesced,
                _FUNCOL.all_reduce, _FUNCOL.all_reduce_coalesced, _FUNCOL.all_to_all_single,
                _FUNCOL.broadcast,
            ) else _nbytes(args[0])
            wire = payload * wire_factor(op, n)
            st.wire_bytes += wire
            if spans_hosts:
                st.wire_bytes_network += wire
            st.bytes_proxy += payload
            d = st.collectives.setdefault(op, {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += 1
            d["bytes"] += payload
            d["wire_bytes"] += wire
        return out


def analyze_step(fn: Callable, *args: Any, world: int = 1, **kwargs: Any) -> StepStats:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter` and
    return its per-rank counts; ``world`` is the group size charged for a
    collective whose group cannot be read."""
    counter = StepCounter(world)
    with counter:
        fn(*args, **kwargs)
    return counter.stats
