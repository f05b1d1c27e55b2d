"""Per-device dot FLOPs, HBM traffic and collective bytes of a traced step.

Counterpart of ``repro.roofline.hlo_analysis``. The reference parses the
partitioned HLO that XLA compiled; PyTorch runs eagerly, so
:class:`TraceCounter`, a ``TorchDispatchMode``, counts the aten ops as the
step runs them (on fake tensors, nothing is computed or allocated):

* dot FLOPs        — ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv`` and
                     ``dot`` (what ``matmul``, ``einsum`` and ``linear``
                     decompose into): 2 · |output| · K. Not convolutions
                     (XLA's ``dot`` excludes them too);
* HBM traffic      — for each op that makes a kernel in eager mode:
                     Σ operand bytes + output bytes. Views, allocations,
                     ``prim`` and metadata ops make none and are excluded;
                     a gather (``embedding``, ``index_select``, ``gather``,
                     ``index``) reads the rows it writes, not its whole
                     table; an in-place index write (``index_copy_``, ``index_add_``,
                     ``index_put_``, ``scatter_*``) counts its index and
                     source, not the buffer it writes into, and ``copy_``
                     its source and destination once each (the reference
                     caps a ``dynamic-update-slice`` the same way);
* collective bytes — output bytes and counts of the reference's five kinds,
                     from ``_c10d_functional`` ops (DTensor's
                     redistributions) and ``c10d`` ops (process-group
                     calls); ``wait_tensor`` is not a collective.

Per device: an op with a DTensor argument returns ``NotImplemented`` here,
so DTensor runs it and this mode counts the local op it issues on rank 0's
shards, and the redistributions' collectives. DTensor's sharding
propagation first runs some ops on global-shape fake tensors to infer
their outputs; those run inside its ``_propagate_tensor_meta*`` frames and
are not counted.

Kernels: a ``ctypes`` launch is no aten op. Each wrapper reports its launch
(``kernels._costs.report``: the dot FLOPs and compulsory bytes of the bound
column of ``PERF.md``'s kernel table) to the innermost active counter,
which counts it by name in ``kernel_calls``.

Repeated blocks: ``launch.dryrun`` traces a model at one and two blocks of
each repeated stack and extends the difference to the stack's length, the
counterpart of the reference multiplying a ``while`` body by its trip
count; the lengths go in ``while_trip_counts``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import _costs

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_COLLECTIVE_OPS = {
    # _c10d_functional (functional collectives: the result is the output)
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # c10d (in place: the first argument holds the output)
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_DOT_LHS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1, "addmv": 1,
            "_addmm_activation": 1}
_NO_KERNEL = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
}
_INDEX_WRITES = {"index_copy_", "index_add_", "index_put_", "scatter_", "scatter_add_",
                 "_index_put_impl_"}
_GATHERS = {"embedding", "index_select", "gather", "index"}
_PROPAGATION_FRAMES = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _in_propagation(depth: int = 12) -> bool:
    """Whether DTensor's sharding propagation is running this op on
    global-shape fake tensors (its frames sit a few calls up)."""
    frame = sys._getframe(2)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name in _PROPAGATION_FRAMES:
            return True
        frame = frame.f_back
    return False


@dataclass
class TraceCost:
    """Per-device counts; ``as_dict()`` has ``HloCost.as_dict()``'s keys
    and ``kernel_calls``."""

    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0)
    )
    collective_counts: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    dot_count: int = 0
    while_trip_counts: List[int] = field(default_factory=list)
    kernel_calls: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "dot_count": self.dot_count,
            "while_trip_counts": list(self.while_trip_counts),
            "kernel_calls": dict(self.kernel_calls),
        }

    @staticmethod
    def combine(terms: Iterable[Tuple["TraceCost", int]]) -> "TraceCost":
        """Σ coefficient · cost, field by field (the repeated-block
        extension: base + length · (two blocks − one block))."""
        out = TraceCost()
        for cost, coef in terms:
            out.dot_flops += coef * cost.dot_flops
            out.traffic_bytes += coef * cost.traffic_bytes
            out.dot_count += coef * cost.dot_count
            for k in COLLECTIVES:
                out.collective_bytes[k] += coef * cost.collective_bytes[k]
                out.collective_counts[k] += coef * cost.collective_counts[k]
            for k, v in cost.kernel_calls.items():
                out.kernel_calls[k] = out.kernel_calls.get(k, 0) + coef * v
        return out


class TraceCounter(TorchDispatchMode):
    """``with TraceCounter() as c: step(...)`` → ``c.cost``, a
    :class:`TraceCost` of everything the step ran in this process (rank 0's
    share on a fake mesh). Kernel launches inside report to it too."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = TraceCost()

    def __enter__(self):
        _costs.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _costs.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, dot_flops: int, nbytes: int) -> None:
        c = self.cost
        c.dot_flops += dot_flops
        c.traffic_bytes += nbytes
        c.dot_count += 1 if dot_flops else 0
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _in_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        c = self.cost
        if ns in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                written = _tensors(out) if ns == "_c10d_functional" else _tensors(args[0])
                c.collective_bytes[kind] += _nbytes(written)
                c.collective_counts[kind] += 1
                c.traffic_bytes += _nbytes(_tensors(args)) + _nbytes(written)
            return
        if ns == "prim" or func.is_view or name in _NO_KERNEL:
            return
        lhs = _DOT_LHS.get(name)
        if lhs is not None and ns == "aten":
            k = args[lhs].shape[-1] if args[lhs].dim() else 1
            c.dot_flops += 2 * out.numel() * k
            c.dot_count += 1
        ins = _tensors((args, kwargs))
        if name in _GATHERS:
            written = _nbytes(_tensors(out))
            indices = [t for t in ins if not t.is_floating_point()]
            c.traffic_bytes += 2 * written + _nbytes(indices)
        elif name in _INDEX_WRITES:
            source = ins[-1] if ins else None
            c.traffic_bytes += _nbytes(ins[1:]) + (_nbytes([source]) if source is not None else 0)
        elif name == "copy_":
            c.traffic_bytes += _nbytes(ins[:2])
        else:
            c.traffic_bytes += _nbytes(ins) + _nbytes(_tensors(out))

