"""The zoo's step on DTensor parameters, batches and caches.

A model-zoo function given DTensors (``launch.sharding`` places them on a
``DeviceMesh``) runs under :func:`spmd_scope`: DTensor's sharding
propagation carries the matmuls, norms and elementwise ops, and a plain
tensor made inside the step (positions, RoPE and M-RoPE angles, masks,
accumulators) joins as replicated (``implicit_replication``). On plain
tensors none of this runs: every helper here returns its input, or calls
its function, as it is.

Where propagation has no rule for what the step does (a reshape that
merges a sharded head dim into a strided shard that ``bmm`` then refuses,
an in-place write into a sharded cache at a device-side slot), the region
runs on each device's local shards through :func:`local_region`
(``torch.distributed.tensor.experimental.local_map``) with its placements
stated. The regions are listed in the docstrings of ``layers``, ``moe``
and ``ssm``; each states its placements in terms of the mesh's batch axes
(``launch.sharding.batch_spec``'s) and its ``model`` axis.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.launch import sharding as SH


def is_dtensor(t: Any) -> bool:
    return isinstance(t, DTensor)


def spmd_scope(t: Any):
    """``implicit_replication()`` when ``t`` (a parameter) is a DTensor and
    no outer scope holds it (its exit clears the flag, so a nested scope
    would end the outer one early: the train step's backward runs after
    ``loss_fn`` returns); else a context that does nothing."""
    if not is_dtensor(t) or getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return nullcontext()
    return implicit_replication()


def scoped(fn: Callable) -> Callable:
    """``fn(params, ...)`` under :func:`spmd_scope` of the module's first
    parameter: the zoo's ``loss_fn``, ``prefill_fn``, ``decode_fn`` and
    ``hidden_fn``."""

    @functools.wraps(fn)
    def run(params, *args):
        with spmd_scope(next(params.parameters(), None)):
            return fn(params, *args)

    return run


@contextmanager
def stack_views(caches) -> Iterator[None]:
    """For one decode step: every DTensor leaf of a stacked cache (under
    ``blocks``, ``super``, ...) split along its stack dim is replaced in
    the tree by a replicated copy, and copied back into its own shards
    after. The zoo writes a cache in place through per-layer views
    (``model_zoo._layer``); a leaf split along the stack dim has none (the
    reference's ``cache_spec`` splits a stack of 0-d write indices over the
    data axes). A plain tree is left as it is."""
    swapped = []

    def walk(tree, stacked):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, stacked or key in SH.STACK_NAMES)
            elif stacked and is_dtensor(leaf) and any(
                isinstance(p, Shard) and p.dim == 0 for p in leaf.placements
            ):
                swapped.append((tree, key, leaf))
                tree[key] = leaf.redistribute(placements=SH.replicated(leaf.device_mesh))

    if isinstance(caches, dict):
        walk(caches, False)
    try:
        yield
    finally:
        for tree, key, leaf in swapped:
            leaf.copy_(tree[key].redistribute(placements=leaf.placements))
            tree[key] = leaf


def model_size(mesh) -> int:
    return SH.axis_sizes(mesh).get("model", 1)


def batch_entry(mesh, b: int):
    """The spec entry of a batch dim of size b: ("pod", "data"), "data" or
    None (``launch.sharding.batch_spec``)."""
    return SH.batch_spec((b,), mesh)[0]


class Pending(NamedTuple):
    """An output spec whose mesh axes ``axes`` hold a pending sum
    (``Partial("sum")``): each device's value is a partial sum."""

    spec: Tuple[Any, ...]
    axes: Tuple[str, ...]


def placements(spec, mesh) -> tuple:
    """``launch.sharding.placements`` of a spec, or of a :class:`Pending`
    with ``Partial("sum")`` on its axes."""
    if isinstance(spec, Pending):
        out = list(SH.placements(tuple(spec.spec), mesh))
        for name in spec.axes:
            out[SH.axis_names(mesh).index(name)] = Partial("sum")
        return tuple(out)
    return SH.placements(tuple(spec), mesh)


def as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor as a replicated DTensor on ``mesh``; a DTensor as it
    is."""
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * len(SH.axis_names(mesh)), run_check=False)


def pin(t: torch.Tensor, spec: Sequence[Any]) -> torch.Tensor:
    """``t`` redistributed to ``spec`` on its mesh (the reference's
    ``with_sharding_constraint``); a plain tensor, or a mesh without one of
    the spec's axes, leaves it as it is (the reference's ``try/except`` on
    one device)."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    names = set(SH.axis_names(mesh))
    for entry in spec:
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            if name not in names:
                return t
    target = SH.placements(tuple(spec), mesh)
    return t if tuple(t.placements) == target else t.redistribute(placements=target)


def rows(t: torch.Tensor) -> torch.Tensor:
    """An activation (B, ...) placed by its batch only: the batch over the
    batch axes when it divides, every other dim whole (a column-parallel
    product's input takes this layout, so a (B, S, d) → (B·S, d) fold
    never meets a sharded S)."""
    if not is_dtensor(t):
        return t
    return pin(t, (batch_entry(t.device_mesh, t.shape[0]),) + (None,) * (t.dim() - 1))


def model_dim(t: torch.Tensor) -> Optional[int]:
    """The dim a DTensor splits over ``model`` (None for a plain tensor, or
    one whole over ``model``)."""
    if not is_dtensor(t):
        return None
    for name, p in zip(SH.axis_names(t.device_mesh), t.placements):
        if name == "model" and isinstance(p, Shard):
            return p.dim
    return None


class _GradAs(torch.autograd.Function):
    """Identity; the gradient is redistributed to the forward's placements,
    a pending sum's axes replicated (a sharding propagation's own choice may
    leave it in a layout the next product has no rule for)."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(placements=ctx.placements)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x already promoted by the caller). On DTensors the product
    follows the weight's own ``model`` split (``launch.sharding.param_spec``
    puts it on the weight's largest dim), and the weight is gathered over
    the data axes (FSDP's gather; the backward reduce-scatters its
    gradient):

    * ``model`` on the output dim (column parallel): x by its batch only,
      the output split over ``model`` on its last dim, no collective;
    * ``model`` on the input dim (row parallel): x split over ``model`` on
      its last dim (where the previous column-parallel product left it),
      the output a pending sum over ``model``, reduced where the next op
      needs it;
    * neither: x by its batch only and the weight whole, the product
      repeated on every ``model`` device, as the placement implies.

    x keeps its batch split when it is already there (``batch_both_axes``
    splits it over ``model`` too, when the weight is whole over
    ``model``). The gradient is kept in the product's layout."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    mesh = (w if is_dtensor(w) else x).device_mesh
    split = model_dim(w)
    nd = w.dim()
    bat = batch_entry(mesh, x.shape[0])
    if split is None and is_dtensor(x):
        own = spec_of(x)[0]
        bat = own if own is not None else bat
    if split == nd - 2:
        xs = (bat,) + (None,) * (x.dim() - 2) + ("model",)
        ws = (None,) * (nd - 2) + ("model", None)
    else:
        xs = (bat,) + (None,) * (x.dim() - 1)
        ws = (None,) * (nd - 1) + ("model" if split == nd - 1 else None,)
    out = pin(x, xs) @ pin(w, ws)
    return _GradAs.apply(out) if torch.is_grad_enabled() and out.requires_grad else out


def heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A projection's output (B, S, n_heads·dh) placed by its batch and, when
    n_heads divides over ``model``, its heads: the layout in which the
    split into (n_heads, dh) is a plain view."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    split = "model" if n_heads % model_size(mesh) == 0 else None
    return pin(t, (batch_entry(mesh, t.shape[0]),) + (None,) * (t.dim() - 2) + (split,))


def spec_of(t: DTensor) -> Tuple[Any, ...]:
    """The spec of a DTensor's placements (each dim's mesh axes; Partial
    and Replicate name none)."""
    names = SH.axis_names(t.device_mesh)
    dims: list = [[] for _ in range(t.dim())]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d)) for d in dims)


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of a spec entry (None, a name or a tuple of names)."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def batch_axes(mesh, b: int) -> Tuple[str, ...]:
    """The mesh axes a batch dim of size b is split over."""
    return axes_of(batch_entry(mesh, b))


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The number of shards of a dim split over ``axes``."""
    sizes = SH.axis_sizes(mesh)
    out = 1
    for name in axes:
        out *= sizes[name]
    return out


def coordinate(mesh, axes: Sequence[str]) -> int:
    """This device's index among the shards of a dim split over ``axes`` (in
    that order, the first outermost)."""
    sizes = SH.axis_sizes(mesh)
    out = 0
    for name in axes:
        out = out * sizes[name] + mesh.get_local_rank(name)
    return out


def local_region(fn: Callable, out_specs, in_specs: Sequence[Any], mesh, *args, grad_specs=None):
    """``fn(*args)`` on each device's local shards: every tensor argument is
    made a DTensor (a plain one replicated) and redistributed to its spec of
    ``in_specs``; the outputs are DTensors of ``out_specs`` (a spec or
    :class:`Pending`, or a list of them for a tuple of outputs). A
    non-tensor argument takes None. ``grad_specs`` (aligned with the
    arguments, None for the input's own spec) states where an input's local
    gradient is a pending sum: a weight gathered whole on devices that see
    different rows, an input that devices split other work over."""
    grads = grad_specs or [None] * len(args)
    ins, flat, grad_in = [], [], []
    for a, s, g in zip(args, in_specs, grads):
        if torch.is_tensor(a):
            flat.append(as_dtensor(a, mesh))
            ins.append(placements(s, mesh))
            grad_in.append(placements(g if g is not None else s, mesh))
        else:
            flat.append(a)
            ins.append(None)
            grad_in.append(None)
    # local_map reads a tuple as one placement list per output, a list as one output's
    if isinstance(out_specs, list):
        outs = tuple(list(placements(s, mesh)) for s in out_specs)
    else:
        outs = list(placements(out_specs, mesh))
    wrapped = local_map(
        fn, out_placements=outs, in_placements=tuple(ins), device_mesh=mesh,
        redistribute_inputs=True, in_grad_placements=tuple(grad_in),
    )
    return wrapped(*flat)
