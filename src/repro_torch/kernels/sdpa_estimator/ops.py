"""Public wrappers of the Eq. 10 SDPA estimator kernel.

Counterparts of ``repro.kernels.sdpa_estimator.ops.sdpa_estimate_batched``
and ``sdpa_estimate``, with their signatures. Inputs are cast to float32 (as
the reference op does) and checked; then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel
  (``csrc/sdpa_estimator.cu``) on the current stream, or raises. There is no
  fallback: a build failure, a refused launch or an unsupported shape is an
  error. The kernel has no backward, so an input that requires grad under
  grad is refused too (``core.estimator.sdpa_transform_differentiable`` is
  Eq. 10 with autograd).

The kernel reads its inputs by TMA through their batch and row strides, so
a batch axis broadcast with ``expand`` (stride 0) reaches it without a
copy. TMA needs a 16-byte aligned base and strides that are multiples of
16 bytes: an input without them (a width that is not a multiple of 4
floats, an offset view) is first copied into padded rows. The last
dimension must be contiguous. The key axis N_o is cut into contiguous
ranges, one block each, where the query rows alone would leave SMs idle
(:func:`launch_plan`, cached per shape and SM count); with more than one
range a second, small kernel merges them. ``LAUNCHES`` counts calls that
launched the kernel, whether or not the call also ran the merge.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, _costs
from repro_torch.kernels.sdpa_estimator import ref

# The kernel's geometry (csrc names in brackets). The plan below is computed
# without the library, so these are kept here too; loading the library
# checks them against the kernel's own (``sdpa_estimator_geometry``).
MAX_WIDTH = 256  # widest d and d_b the kernel takes (MAX_D)
MAX_BATCH = 65535  # the kernel's grid puts the batch on gridDim.y
BM = 64  # query rows a block (BM)
BN = 32  # keys a K/V tile (BN)
COLS = 128  # widest d_b chunk a block accumulates (COLS)
BOX = 32  # floats in a TMA box row (BOX)
MIN_BLOCKS = 2  # blocks an SM holds by registers, from __launch_bounds__ (MIN_BLOCKS)
SM_SMEM = 233_472  # bytes of shared memory on an H100 SM (228 KB); a block also reserves 1 KB
# A key range costs about one tile of work besides its own tiles: its q tile
# staged again and its row of the merge.
RANGE_COST_TILES = 1
LAUNCHES = 0

_fn = None
_sms: dict = {}


class Plan(NamedTuple):
    """How a launch cuts the key axis: ``splits`` ranges of ``per_tiles``
    tiles of BN keys (the last range may be shorter), one block per range,
    column chunk and BM query rows. ``sms`` is the SM count it was made for."""

    splits: int
    per_tiles: int
    blocks: int
    sms: int

    def ranges(self, no: int) -> List[Tuple[int, int]]:
        """The key ranges [start, end) the blocks walk, as the kernel computes them."""
        step = self.per_tiles * BN
        return [(i * step, min(no, (i + 1) * step)) for i in range(self.splits)]


def split_plan(b: int, nu: int, no: int, db: int, sms: int, want: int) -> Plan:
    """At least ``want`` key ranges (fewer if N_o has too few tiles), each a
    whole number of tiles and none empty."""
    tiles = -(-no // BN)
    per = max(1, tiles // max(1, want))
    splits = -(-tiles // per)
    row_blocks = b * -(-nu // BM) * -(-db // COLS)
    return Plan(splits, per, row_blocks * splits, sms)


def smem_bytes(d: int, db: int) -> int:
    """Dynamic shared memory of a block (csrc: smem_bytes): the q tile, two
    K and two V stages in 32-float boxes, 1 KB of alignment slack, two
    mbarriers."""
    q_k_boxes, v_boxes = -(-d // BOX), -(-min(db, COLS) // BOX)
    return 1024 + 4 * BOX * (q_k_boxes * (BM + 2 * BN) + 2 * BN * v_boxes) + 16


def blocks_per_sm(d: int, db: int) -> int:
    """Blocks of the kernel an H100 SM holds at once: as many as shared
    memory allows, up to the MIN_BLOCKS its registers are bounded for."""
    return max(1, min(MIN_BLOCKS, SM_SMEM // (smem_bytes(d, db) + 1024)))


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, nu: int, no: int, d: int, db: int, sms: int) -> Plan:
    """The wrapper's plan for a shape on a card with ``sms`` SMs. One range
    when the query rows alone give a block an SM (few-shot step ③'s pool),
    and no merge, even where more ranges would be faster (``chip_smoke.py``'s
    ``[plan]`` rows time both); else the range length whose launch takes the fewest tile-times: waves of
    blocks (``blocks_per_sm`` resident on each SM) times the tiles a block
    walks plus RANGE_COST_TILES, fewer ranges on a tie. No query rows
    (an empty private pool) make one range of no blocks: nothing launches."""
    tiles = -(-no // BN)
    row_blocks = b * -(-nu // BM) * -(-db // COLS)
    if row_blocks == 0 or row_blocks >= sms:
        return Plan(1, tiles, row_blocks, sms)
    slots = sms * blocks_per_sm(d, db)
    best = None
    for want in range(1, min(tiles, 4 * slots // row_blocks + 1) + 1):
        plan = split_plan(b, nu, no, db, sms, want)
        waves = -(-plan.blocks // slots)
        key = (waves * (plan.per_tiles + RANGE_COST_TILES), plan.splits)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


# the C entry's arguments: q, k, v, out, part_acc, part_ml; B, N_u, N_o, d,
# d_b; six strides; splits, per_tiles; scale; stream
ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_void_p]
)


# widths at which the load checks smem_bytes against the kernel's: each
# box-count boundary of d and of the d_b chunk
_GEOMETRY_WIDTHS = (1, 32, 33, 64, 65, 128, 129, 200, 256)


def _check_geometry(lib) -> None:
    """Raise unless this module's copy of the kernel's geometry is the
    kernel's own."""
    query = lib.sdpa_estimator_geometry
    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    query.restype = None
    out = (ctypes.c_longlong * 7)()
    for d in _GEOMETRY_WIDTHS:
        for db in _GEOMETRY_WIDTHS:
            query(d, db, out)
            ours = (BM, BN, COLS, BOX, MAX_WIDTH, MIN_BLOCKS, smem_bytes(d, db))
            if tuple(out) != ours:
                raise RuntimeError(
                    f"sdpa_estimator geometry at d={d}, d_b={db}: the kernel has {tuple(out)}, "
                    f"ops.py {ours} (BM, BN, COLS, BOX, MAX_D, MIN_BLOCKS, shared bytes)"
                )


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load_library("sdpa_estimator")
        _check_geometry(lib)
        fn = lib.sdpa_estimator_f32
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def device_plan(h_u: torch.Tensor, h_o_b: torch.Tensor) -> Plan:
    """:func:`launch_plan` for these inputs on their card (the SM count is
    read once per device)."""
    dev = h_u.device.index if h_u.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:  # a property query per call costs more than the launch
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    b, nu, d = h_u.shape
    return launch_plan(b, nu, h_o_b.shape[1], d, h_o_b.shape[2], _sms[dev])


def _check(h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> None:
    for name, t in (("h_u", h_u), ("h_o_a", h_o_a), ("h_o_b", h_o_b)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, N, d), got shape {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != h_u.device:
            raise ValueError(f"{name} is on {t.device}, h_u on {h_u.device}")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    b, _, d = h_u.shape
    if h_o_a.shape[0] != b or h_o_b.shape[0] != b:
        raise ValueError(f"batch sizes differ: {h_u.shape[0]}, {h_o_a.shape[0]}, {h_o_b.shape[0]}")
    if h_o_a.shape[2] != d:
        raise ValueError(f"h_o_a width {h_o_a.shape[2]} != h_u width {d}")
    if h_o_b.shape[1] != h_o_a.shape[1]:
        raise ValueError(f"h_o_b rows {h_o_b.shape[1]} != h_o_a rows {h_o_a.shape[1]}")
    if h_o_a.shape[1] < 1:
        raise ValueError("the overlap set H_o is empty: nothing to attend over")
    for name, width in (("d", d), ("d_b", h_o_b.shape[2])):
        if not 1 <= width <= MAX_WIDTH:
            raise ValueError(f"{name}={width} is outside the kernel's 1..{MAX_WIDTH}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} is outside 1..{MAX_BATCH}")


def sdpa_estimate_batched(
    h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor
) -> torch.Tensor:
    """Eq. 10 per batch entry as ONE launch.

    h_u (B, N_u, d), h_o_a (B, N_o, d), h_o_b (B, N_o, d_b) →
    (B, N_u, d_b) f32. Scale 1/√d of the true d."""
    _check(h_u, h_o_a, h_o_b)
    h_u, h_o_a, h_o_b = h_u.float(), h_o_a.float(), h_o_b.float()
    if h_u.device.type == "cpu":
        return ref.sdpa_estimate_batched(h_u, h_o_a, h_o_b)
    if h_u.device.type != "cuda":
        raise ValueError(f"no SDPA route for device {h_u.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h_u, h_o_a, h_o_b)):
        raise NotImplementedError(
            "the Eq. 10 kernel has no backward: call it without grad, or differentiate "
            "through repro_torch.core.estimator.sdpa_transform_differentiable"
        )
    return launch(h_u, h_o_a, h_o_b, device_plan(h_u, h_o_b))


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA reads t in place: a 16-byte aligned base, and batch and row strides
    that are multiples of 4 elements (a row stride above 0)."""
    b, n, _ = t.shape
    rows_ok = n == 1 or (t.stride(1) > 0 and t.stride(1) % 4 == 0)
    return t.data_ptr() % 16 == 0 and rows_ok and (b == 1 or t.stride(0) % 4 == 0)


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """t, or where TMA cannot read it in place (a width that is not a
    multiple of 4 floats, an offset view), a copy whose rows are padded to
    16 bytes, viewed at t's width."""
    if _tma_ready(t):
        return t
    b, n, w = t.shape
    padded = t.new_zeros((b, n, -(-w // 4) * 4))
    padded[..., :w] = t
    return padded[..., :w]


def _strides(t: torch.Tensor) -> Tuple[int, int]:
    """(batch, row) strides for the kernel: a single batch entry reads as
    broadcast (0), and a single row gets its width padded to 4 as stride."""
    b, n, w = t.shape
    return (0 if b == 1 else t.stride(0)), (t.stride(1) if n > 1 else -(-w // 4) * 4)


def launch(
    h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor, plan: Plan
) -> torch.Tensor:
    """Launch the kernel on checked f32 CUDA inputs with a given plan (the
    wrapper passes :func:`device_plan`'s; a benchmark may pass another)."""
    global LAUNCHES
    b, nu, d = h_u.shape
    no, db = h_o_b.shape[1], h_o_b.shape[2]
    out = torch.empty((b, nu, db), device=h_u.device, dtype=torch.float32)
    if nu == 0:
        return out
    part_acc = part_ml = None
    if plan.splits > 1:
        rows = plan.splits * b * nu
        part_acc = torch.empty(rows * -(-db // 4) * 4, device=h_u.device, dtype=torch.float32)
        part_ml = torch.empty(rows * 2, device=h_u.device, dtype=torch.float32)
    fn = _kernel()
    h_u, h_o_a, h_o_b = (_tma_view(t) for t in (h_u, h_o_a, h_o_b))
    ptrs = (h_u.data_ptr(), h_o_a.data_ptr(), h_o_b.data_ptr(), out.data_ptr())
    ptrs += tuple(None if t is None else t.data_ptr() for t in (part_acc, part_ml))
    strides = tuple(s for t in (h_u, h_o_a, h_o_b) for s in _strides(t))
    sizes = (b, nu, no, d, db)
    scale = 1.0 / math.sqrt(d)
    err = _build.call(fn, h_u.device, *ptrs, *sizes, *strides, plan.splits, plan.per_tiles, scale)
    if err != 0:
        raise RuntimeError(f"sdpa_estimator launch failed: cudaError_t {err}")
    LAUNCHES += 1
    if _costs.COUNTERS:  # queries and keys once (once for the batch as stride-0 views)
        qk = sum(
            t.shape[1] * d * (1 if st == 0 else b) for t, st in ((h_u, strides[0]), (h_o_a, strides[2]))
        )
        nbytes = h_u.element_size() * (qk + b * no * db) + 4 * b * nu * db
        _costs.report("sdpa_estimator", 2 * b * nu * no * (d + db), nbytes)
    return out


def sdpa_estimate(h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> torch.Tensor:
    """Eq. 10 for one entry: (N_u, d), (N_o, d), (N_o, d_b) → (N_u, d_b) f32.
    The width-1 case of :func:`sdpa_estimate_batched`."""
    return sdpa_estimate_batched(h_u[None], h_o_a[None], h_o_b[None])[0]
