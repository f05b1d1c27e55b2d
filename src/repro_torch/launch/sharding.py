"""Sharding specs for the zoo's parameter, optimizer, batch and cache trees,
and their DTensor placements.

Counterpart of ``repro.launch.sharding``, rule for rule:

* Parameters: 2-D tensor parallel × FSDP. For each leaf the largest
  divisible dim is sharded over ``model`` and the next largest divisible
  dim over ``data``. Leading layer-stack dims are never sharded. A
  multi-pod mesh replicates parameters across ``pod``.
* Batches: the global batch over (``pod``, ``data``) when divisible, else
  ``data``, else replicated.
* Decode caches: the batch dim as a batch's; the largest divisible dim
  after the length dim over ``model``; the length dim never.

A spec is a plain tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names such as ``("pod", "data")`` (the
reference's ``PartitionSpec`` entries). The rules read only the mesh's
axis names and sizes, from a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``shape``) or from an object with ``axis_names`` and
``devices.shape``, as the reference's tests fake a mesh.
:func:`placements` turns a spec into DTensor placements, one per mesh dim.

The reference's parameter tree stacks repeated blocks on leading dims; the
port's modules keep them as ``nn.ModuleList`` entries. :func:`stacked_leaf`
maps a module parameter's name (``blocks.3.ffn.w_up``) to its stacked
leaf's names and stack index, and :func:`module_placements` places each
module parameter by its stacked leaf's spec without the stack dims.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Any, ...]

# containers whose children carry leading layer-stack dims
_STACK1 = ("blocks", "enc_blocks", "dec_blocks", "rest")
_STACK2 = ("super",)
STACK_NAMES = _STACK1 + _STACK2


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _stack_depth(names: Sequence[str]) -> int:
    if any(n in _STACK2 for n in names):
        return 2
    if any(n in _STACK1 for n in names):
        return 1
    return 0


def param_spec(
    names: Sequence[str],
    shape: Tuple[int, ...],
    mesh,
    fsdp_only: bool = False,
    embed_single_axis: bool = False,
) -> Spec:
    """One parameter leaf's spec. ``fsdp_only``: no ``model`` sharding; the
    ``data`` shard goes on the first divisible body dim (the input dim).
    ``embed_single_axis``: the embedding and unembedding tables shard their
    largest divisible dim over ``model`` only."""
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    depth = min(_stack_depth(names), len(shape))
    body = list(shape[depth:])
    spec: list = [None] * len(shape)
    if not body:
        return tuple(spec)
    order = sorted(range(len(body)), key=lambda i: -body[i])

    if embed_single_axis and any(n in ("tok", "unembed") for n in names):
        for i in order:
            if body[i] % model_n == 0 and body[i] >= model_n:
                spec[depth + i] = "model"
                break
        return tuple(spec)

    if fsdp_only:
        for i in range(len(body)):
            if body[i] % data_n == 0 and body[i] >= data_n:
                spec[depth + i] = "data"
                break
        return tuple(spec)

    used = None
    for i in order:  # the largest divisible dim → model
        if body[i] % model_n == 0 and body[i] >= model_n:
            spec[depth + i] = "model"
            used = i
            break
    for i in order:  # the next largest divisible dim → data
        if i != used and body[i] % data_n == 0 and body[i] >= data_n:
            spec[depth + i] = "data"
            break
    return tuple(spec)


def map_tree(tree, fn, path=()):
    """``fn(names, leaf)`` over a nested dict of leaves (TensorSpecs, or
    anything with a ``shape``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn(list(path), tree)


def param_specs(
    shapes_tree, mesh, fsdp_only_paths: Tuple[str, ...] = (), embed_single_axis: bool = False
):
    """TensorSpec tree → spec tree (same structure). A leaf whose path holds
    a name of ``fsdp_only_paths`` is sharded data-only (no tensor
    parallelism); a 0-d leaf is replicated."""

    def one(names, leaf):
        if len(leaf.shape) == 0:
            return ()
        fsdp_only = any(n in fsdp_only_paths for n in names)
        return param_spec(names, tuple(leaf.shape), mesh, fsdp_only, embed_single_axis)

    return map_tree(shapes_tree, one)


def shard_params(
    shapes_tree, mesh, fsdp_only_paths: Tuple[str, ...] = (), embed_single_axis: bool = False
):
    """TensorSpec tree → placements tree (same structure, the reference's
    leaf names)."""
    specs = param_specs(shapes_tree, mesh, fsdp_only_paths, embed_single_axis)
    return map_tree(specs, lambda _, s: placements(s, mesh))


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    sizes = axis_sizes(mesh)
    pod_n = sizes.get("pod", 1)
    data_n = sizes.get("data", 1)
    if len(shape) == 0:
        return ()
    spec: list = [None] * len(shape)
    b = shape[0]
    if pod_n > 1 and b % (pod_n * data_n) == 0:
        spec[0] = ("pod", "data")
    elif b % data_n == 0 and b >= data_n:
        spec[0] = "data"
    return tuple(spec)


def batch_specs(spec_tree, mesh):
    return map_tree(spec_tree, lambda _, leaf: batch_spec(tuple(leaf.shape), mesh))


def shard_batch(spec_tree, mesh):
    return map_tree(batch_specs(spec_tree, mesh), lambda _, s: placements(s, mesh))


def cache_spec(names: Sequence[str], shape: Tuple[int, ...], mesh) -> Spec:
    """A decode-cache leaf (stack dims..., batch, length, heads / features...):
    the batch dim over (pod, data) or data when divisible, the largest
    divisible dim after the length dim over ``model``."""
    sizes = axis_sizes(mesh)
    pod_n = sizes.get("pod", 1)
    data_n = sizes.get("data", 1)
    model_n = sizes.get("model", 1)
    if len(shape) == 0:
        return ()
    depth = min(_stack_depth(names), len(shape) - 1)
    spec: list = [None] * len(shape)
    b = shape[depth]
    if pod_n > 1 and b % (pod_n * data_n) == 0 and b >= pod_n * data_n:
        spec[depth] = ("pod", "data")
    elif b % data_n == 0 and b >= data_n:
        spec[depth] = "data"
    best = None
    for i in range(len(shape) - 1, depth + 1, -1):
        if shape[i] % model_n == 0 and shape[i] >= model_n:
            if best is None or shape[i] > shape[best]:
                best = i
    if best is not None:
        spec[best] = "model"
    return tuple(spec)


def cache_specs(shapes_tree, mesh):
    def one(names, leaf):
        return cache_spec(names, tuple(leaf.shape), mesh) if len(leaf.shape) else ()

    return map_tree(shapes_tree, one)


def shard_cache(shapes_tree, mesh):
    return map_tree(cache_specs(shapes_tree, mesh), lambda _, s: placements(s, mesh))


def replicated(mesh) -> Tuple[Replicate, ...]:
    return tuple(Replicate() for _ in axis_names(mesh))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on each
    mesh axis that tensor dim d names (several axes on one dim in the spec's
    order), ``Replicate()`` on every other."""
    out = {name: Replicate() for name in axis_names(mesh)}
    for d, entry in enumerate(spec):
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            if name not in out:
                raise ValueError(f"spec {spec} names axis {name!r}, not one of {axis_names(mesh)}")
            out[name] = Shard(d)
    return tuple(out.values())


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """A shard's shape under ``spec``: each dim divided by the sizes of the
    axes that shard it (the specs here only shard divisible dims)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            if out[d] % sizes[name]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {name!r}")
            out[d] //= sizes[name]
    return tuple(out)


def stacked_leaf(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A module parameter's dotted name → (its stacked leaf's names, its
    index along the stack dims): ``blocks.3.ffn.w_up`` → (("blocks", "ffn",
    "w_up"), (3,)); ``super.2.1.mamba.in_proj`` → (("super", "mamba",
    "in_proj"), (2, 1)); ``embed.tok`` → (("embed", "tok"), ())."""
    parts = name.split(".")
    return (
        tuple(p for p in parts if not p.isdigit()),
        tuple(int(p) for p in parts if p.isdigit()),
    )


def leaf_at(tree, names: Sequence[str]):
    for n in names:
        tree = tree[n]
    return tree


def module_specs(
    module, shapes_tree, mesh, fsdp_only_paths: Tuple[str, ...] = (),
    embed_single_axis: bool = False,
) -> Dict[str, Spec]:
    """{module parameter name: its spec}: the stacked leaf's spec (from the
    reference's stacked tree ``shapes_tree``) without the leading stack dims
    the module's list indices stand for."""
    specs = param_specs(shapes_tree, mesh, fsdp_only_paths, embed_single_axis)
    out = {}
    for name, p in module.named_parameters():
        names, index = stacked_leaf(name)
        spec = leaf_at(specs, names)[len(index) :]
        if len(spec) != p.dim():
            raise ValueError(f"{name}: spec {spec} for a {p.dim()}-d parameter")
        out[name] = spec
    return out


def module_placements(
    module, shapes_tree, mesh, fsdp_only_paths: Tuple[str, ...] = (),
    embed_single_axis: bool = False,
) -> Dict[str, tuple]:
    """{module parameter name: its DTensor placements} (:func:`module_specs`)."""
    specs = module_specs(module, shapes_tree, mesh, fsdp_only_paths, embed_single_axis)
    return {name: placements(s, mesh) for name, s in specs.items()}


def replace_parameters(module, make) -> None:
    """Each parameter p of ``module`` replaced in place by
    ``nn.Parameter(make(name, p))`` (``name`` dotted), keeping its
    ``requires_grad``."""
    for name, p in list(module.named_parameters()):
        *path, leaf = name.split(".")
        owner = module
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, torch.nn.Parameter(make(name, p), requires_grad=p.requires_grad))

