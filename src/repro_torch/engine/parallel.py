"""The folds' stacked entry axis, sharded over a batch mesh.

Counterpart of ``repro.engine.parallel``. Every fold (K parties, S seeds, C
scenarios) stacks its entries on one anonymous leading axis; a mesh
(``launch.mesh.BatchMesh``) cuts that axis into D contiguous slices, slot j
running slice j on ``mesh.devices[j]``. One process drives every slot, as
the reference's ``shard_map`` does, so the host-side protocol runs once.

* **No mesh is the one-slot case.** :func:`resolve_mesh` maps ``None``, a
  width of 1 or less and a one-slot mesh to ``None``; the stacked sessions
  then run as one slice on the data's device, with no copy.
* **Keys carry the mesh's identity, never its width or devices.**
  :func:`mesh_key` is ``(axis_names, shape)``, joined to the session keys
  of the sharded domains (``engine.sessions``), so a sharded run's first
  build is a miss of its own and every later width on the same mesh shape
  is a hit. The built steps hold no device: the slots are named by the mesh
  handed to each call.
* **Pad and strip on the host side.** The stacked width must divide by D:
  :func:`pad_entries` / :func:`pad_stacked` append copies of entry 0 (its
  tasks, drawn tensors, schedules and masks, never a fresh draw), and the
  callers keep the first n results (:func:`strip_stacked`) before anything
  is written back. Ledgers are logged from the real entries only.
* **Sessions stay put.** A session of many steps splits its stacked state
  once (:func:`split_stacked`): each slot's parameters and optimizer traces
  live on its device for the whole session, every step launches every
  slot's work before any host read, and :func:`gather_stacked` brings the
  results back to the fold's device at the end. :func:`shard_step` is the
  one-call form, the counterpart of ``shard_jit``.

The reference's ``REPRO_DEVICE_COUNT`` switch has no counterpart: the port
reads no environment, and the mesh arrives through a config alone:
``ProtocolConfig.mesh`` for the protocol folds (and few-shot + finetune's
finetune session), ``IterativeConfig.mesh`` for the baselines' stacked
session (``engine.iterative.run_iterative_session_seeds``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import BatchMesh, make_batch_mesh


def resolve_mesh(mesh: Any = None, device: DeviceLike = None) -> Optional[BatchMesh]:
    """``None`` (no mesh), an int slot count (``launch.mesh.make_batch_mesh``
    on ``device``'s type) or a :class:`BatchMesh` → a mesh of at least two
    slots, or ``None``. Idempotent: every layer the mesh passes through may
    call it."""
    if mesh is None:
        return None
    if isinstance(mesh, bool) or not isinstance(mesh, (int, BatchMesh)):
        raise TypeError(f"a mesh is None, an int or a BatchMesh, not {type(mesh).__name__}")
    if isinstance(mesh, int):
        if mesh <= 1:
            return None
        mesh = make_batch_mesh(mesh, device)
    return None if mesh.size <= 1 else mesh


def fold_mesh(mesh: Any, device: torch.device) -> Optional[BatchMesh]:
    """:func:`resolve_mesh` for a fold on ``device``: a mesh of another
    device type than the fold's is refused."""
    mesh = resolve_mesh(mesh, device)
    if mesh is not None and mesh.devices[0].type != device.type:
        raise ValueError(f"a mesh of {mesh.devices[0].type} slots cannot shard a fold on {device}")
    return mesh


def device_fold(mesh: Optional[BatchMesh]) -> int:
    """The slot count a resolved mesh folds the stacked axis over (1: none)."""
    return 1 if mesh is None else mesh.size


def mesh_key(mesh: Optional[BatchMesh]):
    """The mesh's part of a session key: axis names and shape; ``None``
    without a mesh."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.shape))


def pad_width(n: int, mesh: Optional[BatchMesh]) -> int:
    """Entries to append so ``n`` divides by the mesh's slot count."""
    return 0 if mesh is None else (-n) % mesh.size


def pad_entries(entries: Sequence[Any], mesh: Optional[BatchMesh]) -> List[Any]:
    """A host-side entry list padded to a multiple of the slot count by
    repeating entry 0 (the same object)."""
    entries = list(entries)
    return entries + [entries[0]] * pad_width(len(entries), mesh)


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a tree of dicts, lists, tuples (named
    ones too) and dataclasses; other leaves (None, ints) stay as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    return tree


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def pad_stacked(tree: Any, pad: int) -> Any:
    """Append ``pad`` copies of entry 0 along axis 0 of every tensor."""
    if pad == 0:
        return tree
    return _map(lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])]), tree)


def strip_stacked(tree: Any, n: int) -> Any:
    """Inverse of :func:`pad_stacked`: the first ``n`` entries of every tensor."""
    return _map(lambda a: a[:n], tree)


def split_stacked(tree: Any, mesh: Optional[BatchMesh]) -> List[Any]:
    """Slot by slot, the slot's contiguous slice of every tensor's axis 0 on
    the slot's device; ``[tree]`` itself without a mesh. The width must
    divide by the slot count (pad first)."""
    if mesh is None:
        return [tree]
    widths = {a.shape[0] for a in _tensors(tree)}
    if len(widths) != 1:
        raise ValueError(f"stacked tensors of different widths {sorted(widths)} cannot shard together")
    n = widths.pop()
    if n % mesh.size:
        raise ValueError(f"a stacked width of {n} does not divide over {mesh.size} slots: pad it first")
    w = n // mesh.size
    return [
        _map(lambda a, j=j, dev=dev: a[j * w : (j + 1) * w].to(dev), tree)
        for j, dev in enumerate(mesh.devices)
    ]


def gather_stacked(parts: Sequence[Any], device: torch.device) -> Any:
    """The slots' outputs (trees of one structure) joined along axis 0 in
    slot order on ``device``."""
    if len(parts) == 1:
        return _map(lambda a: a.to(device), parts[0])
    columns = iter(zip(*(_tensors(p) for p in parts)))
    return _map(lambda _: torch.cat([a.to(device) for a in next(columns)]), parts[0])


def shard_step(fn: Callable, mesh: Optional[BatchMesh]) -> Callable:
    """The counterpart of ``shard_jit``: ``fn`` run slot by slot over the
    stacked arguments (every tensor's axis 0, padded to a multiple of the
    slot count), slice j on ``mesh.devices[j]``, and its outputs gathered in
    slot order on the device of the first tensor argument. Other arguments
    reach every slot as they are. ``fn`` itself without a mesh."""
    if mesh is None:
        return fn

    def sharded(*args):
        home = _tensors(args)[0].device
        return gather_stacked([fn(*part) for part in split_stacked(args, mesh)], home)

    return sharded
