"""The batch mesh: the device slots the folds' stacked entry axis shards over.

Counterpart of the batch half of ``repro.launch.mesh`` (``BATCH_AXIS``,
``make_batch_mesh``). The reference's mesh is a ``jax.sharding.Mesh`` that
one Python process drives, every device running its slice of the stacked
axis. :class:`BatchMesh` keeps that single-controller shape: a tuple of
device slots, slot j running the j-th contiguous slice of the stacked
entries (``engine.parallel.shard_step``). A mesh may name one device more
than once, as the reference's CPU tests repeat one host: the slots then
share that device and still run the padded, split, per-slot and gathered
path. ``make_production_mesh`` and ``make_debug_mesh`` (the zoo's 2-D and
3-D meshes) are not ported here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.device import DeviceLike

BATCH_AXIS = "batch"


@dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh over the ``"batch"`` axis: slot j is ``devices[j]``. Every
    slot is on the CPU or every slot is a visible card; a CUDA slot without
    an index is card 0."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a batch mesh needs at least one device slot")
        devs = tuple(torch.device("cuda", 0) if d == torch.device("cuda") else d for d in devs)
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"a batch mesh mixes device types {sorted(kinds)}; use one type")
        kind = kinds.pop()
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"unsupported mesh device type {kind!r}; use 'cuda' or 'cpu'")
        if kind == "cuda":
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            missing = sorted({d.index for d in devs if d.index >= visible})
            if missing:
                raise ValueError(
                    f"the batch mesh names card(s) {missing} but {visible} card(s) are visible"
                )
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (BATCH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.size,)


def make_batch_mesh(num_devices: int, device: DeviceLike = None) -> BatchMesh:
    """A ``num_devices``-slot batch mesh of ``device``'s type (``None``:
    CUDA): on the CPU that many slots of the CPU, on CUDA the first
    ``num_devices`` visible cards. Fewer visible cards raise; the mesh is
    never made smaller than asked."""
    n = int(num_devices)
    if n < 1:
        raise ValueError(f"a batch mesh needs at least one slot, not {n}")
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return BatchMesh((torch.device("cpu"),) * n)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(
            f"requested a {n}-card batch mesh but only {visible} card(s) are visible; "
            "name the slots with BatchMesh to repeat a card"
        )
    return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)))
