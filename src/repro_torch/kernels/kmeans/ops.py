"""Public wrappers of the k-means assignment kernel.

Counterparts of ``repro.kernels.kmeans.ops.kmeans_assign_batched`` and
``kmeans_assign``, with their signatures, plus the minimum distance the
inertia needs. Inputs are checked; then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel (``csrc/kmeans_assign.cu``)
  on the current stream, or raises. There is no fallback: a build failure,
  a refused launch or an unsupported input is an error.

float32 and bfloat16 inputs reach the kernel as they are (the arithmetic is
float32, as the reference op casts); any other float type is cast to
float32 first. The kernel takes batch and row strides, so a batch axis
broadcast with ``expand`` (stride 0) needs no copy; only the last dimension
of each input must be contiguous.

Alignment: the kernel reads any input in place. Where the base and the
batch and row strides are 16-byte aligned it reads 16-byte vectors (and
``cp.async`` copies on the tile route); otherwise (d = 77 or 513 floats in
contiguous rows, an offset view) it reads element by element. The wrapper
never pads a copy.

The kernel has two routes, and :func:`launch_plan` (cached per shape and SM
count, the SM count read once per device) picks one:

* **rows** (C up to ``ROWS_MAX_C[elem]``, d up to ``ROWS_MAX_D``, the
  centres within ``ROWS_SMEM_MAX`` of shared memory: every shape of the
  training path). One pass over x: a block stages its entry's centres and
  their norms in shared memory once, then takes ``rows_per_block`` rows, a
  group of ``lanes`` lanes a row holding ``group_rows`` rows at once; a
  block for each such run of rows; one launch.
* **tiles** (larger C). 3xTF32 tensor-core tiles of BM = 128 rows x BN = 64
  centres; where the row tiles alone leave SMs idle the centres are cut
  into ``splits`` ranges of ``per_tiles`` tiles, one block each, and a
  second, small kernel merges the ranges (lowest distance, then lowest
  index).

``LAUNCHES`` counts calls that launched the kernel, whether or not the call
also ran the merge.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, _costs
from repro_torch.kernels.kmeans import ref

# The kernel's geometry (csrc names in brackets). The plan below is computed
# without the library, so these are kept here too; loading the library
# checks them against the kernel's own (``kmeans_geometry``).
ROWS_THREADS = 256  # threads a rows-route block (RT)
ROW_GROUP_ROWS = 2  # rows a lane group holds at once, at most (RR)
LANE_ELEMS = 16  # elements of a row a lane holds, at most (EPL)
ROWS_MAX_D = 512  # widest d the rows route takes (ROWS_MAX_D)
ROWS_SMEM_MAX = 98304  # shared memory the rows route's centres may take (ROWS_SMEM_MAX)
ROWS_MIN_BLOCKS = 2  # rows-route blocks an SM holds by registers (ROWS_MIN_BLOCKS)
CENTRE_GROUP = 8  # centres a lane group reduces at once, at most (CK)
BM = 128  # rows a tile-route block (BM)
BN = 64  # centres a tile (BN)
KC = 32  # columns a chunk of the d sweep (KC)
TILE_THREADS = 128  # threads a tile-route block: 2 x 2 warps of 64 rows x 32 centres (TT)
STAGES = 3  # depth of the tile route's cp.async ring (STAGES)
MIN_BLOCKS = 2  # tile-route blocks an SM holds, from __launch_bounds__ (MIN_BLOCKS)
MAX_BATCH = 65535  # both routes put the batch on gridDim.y
SM_SMEM = 233_472  # bytes of shared memory on an H100 SM (228 KB); a block also reserves 1 KB
# Where the routes cross, by element size (4: float32, 2: bfloat16): the
# rows route up to this many centres, the tile route above. Set from
# chip_smoke.py's crossover [plan] kmeans rows on an H100 at B = 8, N = 2048,
# d = 128 (PERF.md §6), device ms rows / tiles: float32 C = 48 0.0143 /
# 0.0148, C = 56 0.0163 / 0.0147; bfloat16 (the tiles take one TF32 pass)
# C = 16 0.0083 / 0.0099, C = 24 0.0108 / 0.0102. Both routes' work a row
# grows with d (the rows route's FMAs as C·d, the tiles' mma's as 64·d a
# tile of centres), so the cut is taken in C alone; other (B, N, d) are
# not measured.
ROWS_MAX_C = {4: 48, 2: 16}
# A centre range costs about one tile of work besides its own tiles: its
# rows' x chunks staged again and its part of the merge.
RANGE_COST_TILES = 1
LAUNCHES = 0

_fns: dict = {}
_sms: dict = {}


class Plan(NamedTuple):
    """How a launch cuts the work. ``route`` "rows": blocks of
    ``rows_per_block`` rows, ``lanes`` lanes a row, a lane group holding
    ``group_rows`` rows at once, every centre. ``route`` "tiles": blocks of
    BM rows x one of ``splits`` centre ranges of ``per_tiles`` tiles of BN
    centres (the last range may be shorter). ``sms`` is the SM count it was
    made for."""

    route: str
    lanes: int
    group_rows: int
    rows_per_block: int
    splits: int
    per_tiles: int
    blocks: int
    sms: int

    def ranges(self, c: int) -> List[Tuple[int, int]]:
        """The centre ranges [start, end) a block walks, as the kernel
        computes them."""
        if self.route == "rows":
            return [(0, c)]
        step = self.per_tiles * BN
        return [(i * step, min(c, (i + 1) * step)) for i in range(self.splits)]

    def row_spans(self, n: int) -> List[Tuple[int, int]]:
        """The rows [start, end) of one batch entry each block row owns."""
        step = self.rows_per_block
        return [(i, min(n, i + step)) for i in range(0, n, step)]


def vec_elems(elem: int) -> int:
    """Elements of ``elem`` bytes in a 16-byte vector."""
    return 16 // elem


def row_lanes(d: int, elem: int) -> int:
    """Lanes a row on the rows route (csrc: row_lanes): the fewest, a power
    of two, that hold a row in LANE_ELEMS elements each."""
    ve = vec_elems(elem)
    nv, per_lane = -(-d // ve), LANE_ELEMS // ve
    lanes = 1
    while lanes < 32 and lanes * per_lane < nv:
        lanes *= 2
    return lanes


def rows_a_pass(lanes: int, group_rows: int) -> int:
    """Rows a rows-route block holds at once."""
    return (ROWS_THREADS // lanes) * group_rows


def rows_smem_bytes(c: int, d: int, elem: int) -> int:
    """Dynamic shared memory of a rows-route block (csrc: rows_smem_bytes):
    the centres in f32, each row zero-padded to the lanes' full width, and
    their norms."""
    ve, lanes = vec_elems(elem), row_lanes(d, elem)
    vectors = -(-d // ve)
    pitch = lanes * -(-vectors // lanes) * ve
    return 4 * c * (pitch + 1)


def tile_smem_bytes(elem: int) -> int:
    """Dynamic shared memory of a tile-route block (csrc: tile_smem_bytes):
    the ring's stages of x and centre chunks, rows padded by 16 bytes, and
    the (min, argmin) of BM rows that the second warp column hands over."""
    return STAGES * (BM + BN) * (KC + vec_elems(elem)) * elem + 8 * BM


def rows_ok(c: int, d: int, elem: int) -> bool:
    """Whether the rows route can take this shape at all."""
    return d <= ROWS_MAX_D and rows_smem_bytes(c, d, elem) <= ROWS_SMEM_MAX


def rows_plan(b: int, n: int, d: int, elem: int, sms: int, group_rows: int = 0) -> Plan:
    """The rows route: a block for each pass of rows, however many that
    makes. Two rows a lane group, or one where two would give fewer blocks
    than SMs: more, smaller blocks finish sooner at small B·N (PERF.md
    §6)."""
    lanes = row_lanes(d, elem)
    if not group_rows:  # the plan's own choice; a benchmark may pass 1 or 2
        group_rows = ROW_GROUP_ROWS
        if b * -(-n // rows_a_pass(lanes, group_rows)) < sms:
            group_rows = 1
    per_block = rows_a_pass(lanes, group_rows)
    return Plan("rows", lanes, group_rows, per_block, 1, 0, b * -(-n // per_block), sms)


def tile_plan(b: int, n: int, c: int, sms: int, want: int) -> Plan:
    """The tile route with at least ``want`` centre ranges (fewer if C has
    too few tiles), each a whole number of tiles and none empty."""
    tiles = -(-c // BN)
    per = max(1, tiles // max(1, want))
    splits = -(-tiles // per)
    return Plan("tiles", 0, 0, BM, splits, per, b * -(-n // BM) * splits, sms)


def blocks_per_sm(elem: int) -> int:
    """Tile-route blocks an H100 SM holds at once: as many as shared memory
    allows, up to the MIN_BLOCKS its registers are bounded for."""
    return max(1, min(MIN_BLOCKS, SM_SMEM // (tile_smem_bytes(elem) + 1024)))


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n: int, c: int, d: int, elem: int, sms: int) -> Plan:
    """The wrapper's plan for a shape on a card with ``sms`` SMs: the rows
    route up to ROWS_MAX_C[elem] centres (the measured crossover) where it
    can run; else the tile route, one centre range when the row tiles alone give
    a block an SM, else the range count whose launch takes the fewest
    tile-times: waves of blocks (``blocks_per_sm`` resident on each SM)
    times the tiles a block walks plus RANGE_COST_TILES, fewer ranges on a
    tie."""
    if c <= ROWS_MAX_C[elem] and rows_ok(c, d, elem):
        return rows_plan(b, n, d, elem, sms)
    tiles = -(-c // BN)
    row_blocks = b * -(-n // BM)
    if row_blocks >= sms:
        return tile_plan(b, n, c, sms, 1)
    slots = sms * blocks_per_sm(elem)
    best = None
    for want in range(1, min(tiles, 4 * slots // row_blocks + 1) + 1):
        plan = tile_plan(b, n, c, sms, want)
        waves = -(-plan.blocks // slots)
        key = (waves * (plan.per_tiles + RANGE_COST_TILES), plan.splits)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


# the C entry's arguments: x, mu, out, mind, part; B, N, C, d; four
# strides; route, group_rows, splits, per_tiles; stream
ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 4
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)

# (c, d) at which the load checks the geometry: each lanes boundary of d for
# both element sizes, and a few centre counts
_GEOMETRY_SHAPES = [(c, d) for c in (1, 10, 1000) for d in (1, 3, 16, 17, 64, 77, 128, 129, 513)]


def _check_geometry(lib) -> None:
    """Raise unless this module's copy of the kernel's geometry is the
    kernel's own."""
    query = lib.kmeans_geometry
    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    query.restype = None
    out = (ctypes.c_longlong * 16)()
    fixed = (ROWS_THREADS, ROW_GROUP_ROWS, LANE_ELEMS, ROWS_MAX_D, ROWS_SMEM_MAX, ROWS_MIN_BLOCKS)
    fixed += (CENTRE_GROUP, BM, BN, KC, TILE_THREADS, STAGES, MIN_BLOCKS)
    for elem in (4, 2):
        for c, d in _GEOMETRY_SHAPES:
            query(c, d, elem, out)
            ours = fixed + (row_lanes(d, elem), rows_smem_bytes(c, d, elem), tile_smem_bytes(elem))
            if tuple(out) != ours:
                raise RuntimeError(
                    f"kmeans geometry at c={c}, d={d}, elem={elem}: the kernel has {tuple(out)}, "
                    f"ops.py {ours} (RT, RR, EPL, ROWS_MAX_D, ROWS_SMEM_MAX, ROWS_MIN_BLOCKS, "
                    "CK, BM, BN, KC, TT, STAGES, MIN_BLOCKS, lanes, rows shared bytes, "
                    "tile shared bytes)"
                )


def _kernel(dtype: torch.dtype):
    name = "kmeans_assign_bf16" if dtype == torch.bfloat16 else "kmeans_assign_f32"
    if name not in _fns:
        lib = _build.load_library("kmeans")
        if not _fns:
            _check_geometry(lib)
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    for name, t in (("x", x), ("centers", centers)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, rows, d), got shape {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if centers.device != x.device:
        raise ValueError(f"centers are on {centers.device}, x on {x.device}")
    if centers.shape[0] != x.shape[0]:
        raise ValueError(f"batch sizes differ: {x.shape[0]} and {centers.shape[0]}")
    if centers.shape[2] != x.shape[2]:
        raise ValueError(f"centers width {centers.shape[2]} != x width {x.shape[2]}")
    if centers.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError("need at least one center and one feature")
    if not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} is outside 1..{MAX_BATCH} (the grid's y axis)")


def device_plan(x: torch.Tensor, centers: torch.Tensor) -> Plan:
    """:func:`launch_plan` for these float32 or bfloat16 inputs on their card
    (the SM count is read once per device)."""
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:  # a property query per call costs more than the launch
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    b, n, d = x.shape
    return launch_plan(b, n, centers.shape[1], d, x.element_size(), _sms[dev])


def launch(
    x: torch.Tensor, centers: torch.Tensor, plan: Plan, want_min: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel on checked CUDA inputs, both float32 or both
    bfloat16 with contiguous rows, with a given plan (the wrapper passes
    :func:`device_plan`'s; a benchmark may pass another): assignments
    (B, N) int32 and, if ``want_min``, the minimum distances (B, N)
    float32."""
    global LAUNCHES
    b, n, d = x.shape
    c = centers.shape[1]
    out = torch.empty((b, n), device=x.device, dtype=torch.int32)
    mind = torch.empty((b, n), device=x.device, dtype=torch.float32) if want_min else None
    if n == 0:
        return out, mind
    part = None
    if plan.route == "tiles" and plan.splits > 1:
        part = torch.empty(plan.splits * b * n * 2, device=x.device, dtype=torch.float32)
    fn = _kernel(x.dtype)
    ptrs = (x.data_ptr(), centers.data_ptr(), out.data_ptr())
    ptrs += tuple(None if t is None else t.data_ptr() for t in (mind, part))
    strides = (*x.stride()[:2], *centers.stride()[:2])
    route = 0 if plan.route == "rows" else 1
    args = (route, plan.group_rows, plan.splits, plan.per_tiles)
    err = _build.call(fn, x.device, *ptrs, b, n, c, d, *strides, *args)
    if err != 0:
        raise RuntimeError(f"kmeans launch failed: cudaError_t {err} (plan {plan})")
    LAUNCHES += 1
    if _costs.COUNTERS:  # x, the centres and the labels each moved once
        nbytes = x.element_size() * b * (n * d + c * d) + 4 * b * n
        _costs.report("kmeans", 2 * b * n * c * d, nbytes)
    return out, mind


def _route(x: torch.Tensor, centers: torch.Tensor, want_min: bool):
    _check(x, centers)
    if x.device.type == "cpu":
        if want_min:
            return ref.kmeans_assign_min_batched(x, centers)
        return ref.kmeans_assign_batched(x, centers), None
    if x.device.type != "cuda":
        raise ValueError(f"no k-means route for device {x.device}")
    if x.dtype != centers.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        x, centers = x.float(), centers.float()
    if x.stride(2) != 1 or centers.stride(2) != 1:
        raise ValueError("the last dimension of x and centers must be contiguous")
    return launch(x, centers, device_plan(x, centers), want_min)


def kmeans_assign_batched(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_c ‖x_{b,i} − μ_{b,c}‖² per batch entry as ONE launch.

    x (B, N, d), centers (B, C, d) → (B, N) int32; ties go to the lowest
    centre index."""
    return _route(x, centers, want_min=False)[0]


def kmeans_assign_min_batched(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """As :func:`kmeans_assign_batched`, also returning each row's minimum
    squared distance (B, N) float32 from the same launch."""
    return _route(x, centers, want_min=True)


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x (N, d), centers (C, d) → (N,) int32: the width-1 case of
    :func:`kmeans_assign_batched`."""
    return kmeans_assign_batched(x[None], centers[None])[0]
