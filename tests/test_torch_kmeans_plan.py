"""The k-means kernel's launch plan and tile-route arithmetic, held on the CPU.

The CUDA kernel (``kernels/kmeans/csrc/kmeans_assign.cu``) runs only on a
card. What can be held here:

* the plan (``ops.launch_plan``): at every ``chip_smoke.py`` shape, every
  shape of the clustering tests, every step-③ launch of the scenario
  catalog and the edges N = 1, 63, 64, 65; C = 1, 16, 17, 1000; d = 1, 3,
  77, 1024, its blocks visit each (row, centre) pair of each batch entry
  exactly once, by the kernel's own counting; the training path's shapes
  (the catalog's included) take the rows route in one launch (no merge), the large C·d
  shape the tile route with at least a block an SM; shared memory stays
  within what an H100 block may take;
* that loading the library checks this module's copy of the kernel's
  geometry (the plan counts with it) against the kernel's own;
* the tile route's arithmetic, emulated in torch: operands split into TF32
  hi + lo (rounded bit for bit as ``cvt.rna`` rounds, on the int32 view),
  each KC-column chunk's products summed apart (lo·hi + hi·lo + hi·hi) and
  added to the running dot in f32, (x2 − 2·dot) + c2 folded per centre
  range with the lowest index on ties, and the ranges merged as
  ``kmeans_merge`` merges them. The sums inside a chunk are IEEE f32 here,
  not the tensor cores' own accumulation, so only the rounding is the
  kernel's exactly. It agrees with a float64 oracle within the card tests'
  limits (equal assignments outside 1e-5 near-ties, minima within 1e-5),
  where one TF32 pass does not: the reason the kernel takes three;
* the merge kernel's rule (strict '<' over the ranges in index order) gives
  the lexicographic (distance, index) minimum, with −0.0 equal to +0.0.
"""

import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch import scenarios  # noqa: E402
from repro_torch.core.protocol import KMEANS_RESTARTS  # noqa: E402
from repro_torch.kernels.kmeans import ops  # noqa: E402

H100_SMS = 132
H100_BLOCK_SMEM = 232_448  # the most shared memory one H100 block may take (227 KB)
NEAR_TIE = 1e-5  # tests/test_torch_gpu.py's near-tie gap for unit rows
MIN_TOL = 1e-5  # ... and its limit on the minimum distance against f64
PATH_SHAPES = [(8, 2048, 128, 10), (2, 2048, 128, 10), (8, 32, 16, 2), (2, 32, 16, 2)]
# tests/test_torch_clustering.py's shapes, as (B, N, d, C)
CLUSTERING_SHAPES = [
    (3, 1000, 77, 37),
    (8, 2048, 128, 10),
    (2, 32, 16, 2),
    (1, 5, 3, 1),
    (2, 300, 513, 130),
]
EDGE_SHAPES = [
    (2, n, d, c)
    for n, c, d in itertools.product((1, 63, 64, 65), (1, 16, 17, 1000), (1, 3, 77, 1024))
]


def _catalog_shapes():
    """Step ③'s launches on every catalog scenario at its registered sizes,
    as (B, N, d, C): the Lloyd and inertia launches over K·R entries and the
    final one over K, N the aligned rows (a padded split's capacity), d the
    rep width, C the classes."""
    out = []
    for name in scenarios.names():
        spec = scenarios.get(name)
        n = spec.overlap_capacity or spec.overlap
        c = dict(spec.gen_params).get("num_classes", 2)
        out += [(k, n, spec.rep_dim, c) for k in (spec.num_parties * KMEANS_RESTARTS, spec.num_parties)]
    return list(dict.fromkeys(out))


CATALOG_SHAPES = _catalog_shapes()
ALL_SHAPES = list(
    dict.fromkeys(chip_smoke.KMEANS_SHAPES + CLUSTERING_SHAPES + EDGE_SHAPES + CATALOG_SHAPES)
)


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ALL_SHAPES, ids=str)
def test_plan_visits_every_row_and_centre_once(shape, elem):
    b, n, d, c = shape
    plan = ops.launch_plan(b, n, c, d, elem, H100_SMS)
    spans, ranges = plan.row_spans(n), plan.ranges(c)
    assert plan.blocks == b * len(spans) * len(ranges)
    assert all(lo < hi for lo, hi in spans + ranges)  # no block is empty
    counts = np.zeros((n, c), dtype=np.int64)
    for (r0, r1), (c0, c1) in itertools.product(spans, ranges):
        counts[r0:r1, c0:c1] += 1
    assert (counts == 1).all()
    if plan.route == "rows":
        # the kernel's own counting: (RT / lanes) · rows a group rows a block
        lanes = ops.row_lanes(d, elem)
        assert plan.lanes == lanes and lanes & (lanes - 1) == 0 and lanes <= 32
        assert lanes * ops.LANE_ELEMS >= d  # a row fits the group's registers
        assert plan.group_rows in (1, ops.ROW_GROUP_ROWS)
        assert plan.rows_per_block == ops.rows_a_pass(lanes, plan.group_rows)
        assert plan.splits == 1 and c <= ops.ROWS_MAX_C[elem]
        assert ops.rows_smem_bytes(c, d, elem) <= ops.ROWS_SMEM_MAX <= H100_BLOCK_SMEM
    else:
        # the kernel's validity rule for the range count: every range holds a centre
        step = plan.per_tiles * ops.BN
        assert (plan.splits - 1) * step < c <= plan.splits * step
        assert plan.rows_per_block == ops.BM
        assert ops.tile_smem_bytes(elem) <= H100_BLOCK_SMEM


def test_path_shapes_take_the_rows_route_in_one_launch():
    for b, n, d, c in PATH_SHAPES:
        for elem in (4, 2):
            plan = ops.launch_plan(b, n, c, d, elem, H100_SMS)
            assert plan.route == "rows" and plan.splits == 1  # no merge kernel
    # the Lloyd launch: a block an SM at two rows a lane group
    lloyd = ops.launch_plan(8, 2048, 10, 128, 4, H100_SMS)
    assert lloyd.blocks >= H100_SMS and lloyd.group_rows == 2


@pytest.mark.parametrize("shape", CATALOG_SHAPES, ids=str)
def test_catalog_shapes_take_the_rows_route_in_one_launch(shape):
    """The catalog's step-③ launches, up to 8 parties' 32 stacked entries
    (credit/parties-8: rep 8) and N = 2048 (credit/overlap-2048): the rows
    route, one launch, no merge, in both element types."""
    b, n, d, c = shape
    for elem in (4, 2):
        plan = ops.launch_plan(b, n, c, d, elem, H100_SMS)
        assert plan.route == "rows" and plan.splits == 1


def test_catalog_shapes_cover_the_widest_stack():
    assert (32, 128, 8, 2) in CATALOG_SHAPES and (8, 2048, 16, 2) in CATALOG_SHAPES
    assert (16, 96, 32, 4) in CATALOG_SHAPES and (8, 64, 16, 2) in CATALOG_SHAPES


def test_large_centre_sets_take_the_tile_route_across_the_card():
    plan = ops.launch_plan(1, 4096, 1000, 1024, 4, H100_SMS)
    assert plan.route == "tiles" and plan.blocks >= H100_SMS and plan.splits > 1
    # the crossover: 64 centres at the path's width go to the tiles, 37 at d = 77 stay
    assert ops.launch_plan(8, 2048, 64, 128, 4, H100_SMS).route == "tiles"
    assert ops.launch_plan(3, 1000, 37, 77, 4, H100_SMS).route == "rows"
    # ... and at the measured cut: float32 48 / 56 centres, bfloat16 16 / 24
    for elem, last_rows, first_tiles in ((4, 48, 56), (2, 16, 24)):
        assert ops.launch_plan(8, 2048, last_rows, 128, elem, H100_SMS).route == "rows"
        assert ops.launch_plan(8, 2048, first_tiles, 128, elem, H100_SMS).route == "tiles"


def test_blocks_an_sm_holds_fit_its_shared_memory():
    for elem in (4, 2):
        held = ops.blocks_per_sm(elem)
        assert held == ops.MIN_BLOCKS
        assert held * (ops.tile_smem_bytes(elem) + 1024) <= ops.SM_SMEM
    worst = ops.ROWS_MIN_BLOCKS * (ops.ROWS_SMEM_MAX + 1024)
    assert worst <= ops.SM_SMEM


class _FakeLibrary:
    """Stands in for the built library's ``kmeans_geometry``, which fills
    the kernel's constants and, at (c, d, elem), the lanes a row and both
    routes' shared bytes."""

    def __init__(self, **changed):
        self.changed = changed

        def query(c, d, elem, out):
            g = dict(RT=ops.ROWS_THREADS, RR=ops.ROW_GROUP_ROWS, EPL=ops.LANE_ELEMS)
            g.update(ROWS_MAX_D=ops.ROWS_MAX_D, ROWS_SMEM_MAX=ops.ROWS_SMEM_MAX)
            g.update(ROWS_MIN_BLOCKS=ops.ROWS_MIN_BLOCKS, CK=ops.CENTRE_GROUP, BM=ops.BM)
            g.update(BN=ops.BN, KC=ops.KC, TT=ops.TILE_THREADS, STAGES=ops.STAGES)
            g.update(MIN_BLOCKS=ops.MIN_BLOCKS, lanes=ops.row_lanes(d, elem))
            g.update(rows_smem=ops.rows_smem_bytes(c, d, elem))
            g.update(tile_smem=ops.tile_smem_bytes(elem))
            g.update(self.changed)
            for i, value in enumerate(g.values()):
                out[i] = value

        self.kmeans_geometry = query


@pytest.mark.parametrize(
    "changed",
    [{}, {"BM": 64}, {"RR": 1}, {"CK": 4}, {"STAGES": 2}, {"lanes": 64}, {"rows_smem": 1}],
    ids=str,
)
def test_loading_checks_the_plan_geometry_against_the_kernel(changed):
    if not changed:
        ops._check_geometry(_FakeLibrary())
        return
    with pytest.raises(RuntimeError, match="geometry"):
        ops._check_geometry(_FakeLibrary(**changed))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does: add half of the dropped field to the
    magnitude bits and clear the field."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def chunk_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b over one KC-column chunk as the kernel forms it: 3xTF32 (the
    two cross terms, then hi·hi) or one TF32 pass."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def merge_parked(parts):
    """``kmeans_merge``: over the ranges in index order, take a range's
    (min, argmin) only where its distance is strictly lower."""
    best, arg = parts[0]
    for v, a in parts[1:]:
        take = v < best
        best, arg = torch.where(take, v, best), torch.where(take, a, arg)
    return best, arg


def emulate_tiles(x, m, plan, passes=3):
    """The tile route on (N, d) rows and (C, d) centres, f32: per centre
    range, the dots summed chunk by chunk in f32, (x2 − 2·dot) + c2 and the
    range's (min, argmin) with the lowest index on ties; then the merge."""
    x2 = (x * x).sum(-1, keepdim=True)
    parts = []
    for lo, hi in plan.ranges(m.shape[0]):
        mr = m[lo:hi]
        dot = torch.zeros(x.shape[0], hi - lo)
        for k0 in range(0, x.shape[1], ops.KC):
            dot = dot + chunk_product(x[:, k0 : k0 + ops.KC], mr[:, k0 : k0 + ops.KC].T, passes)
        dist = (x2 - 2.0 * dot) + (mr * mr).sum(-1)
        arg = dist.argmin(-1)  # the first (lowest) index on ties
        parts.append((dist.gather(-1, arg[:, None])[:, 0], arg + lo))
    return merge_parked(parts)


def oracle64(x, m):
    """Distances in float64 of the same expansion, the best and the gap to
    the second best."""
    xd, md = x.double(), m.double()
    dist = (xd * xd).sum(-1, keepdim=True) - 2 * xd @ md.T + (md * md).sum(-1)
    top = dist.topk(2, dim=-1, largest=False).values
    return dist.argmin(-1), top[:, 0], top[:, 1] - top[:, 0]


def _unit(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0**-10  # TF32's step in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23, 1.0 + 1.5 * ulp])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp])
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([math.pi]))
    assert abs((hi + lo).item() - math.pi) < 2**-21 and abs(lo.item()) <= 2**-10
    # a bfloat16 value is its own TF32 rounding: its lo part is 0
    bf = torch.randn(64).bfloat16().float()
    assert torch.equal(tf32(bf), bf) and torch.equal(split(bf)[1], torch.zeros(64))


def test_3xtf32_tile_route_matches_f64_where_one_pass_does_not():
    b, n, d, c = 1, 512, 1024, 200
    x, m = _unit(0, (n, d)), _unit(1, (c, d))
    plan = ops.launch_plan(b, n, c, d, 4, H100_SMS)
    assert plan.route == "tiles" and plan.splits > 1  # the merge is exercised
    want, want_min, gap = oracle64(x, m)
    exempt = gap <= NEAR_TIE
    got_min, got = emulate_tiles(x, m, plan)
    assert torch.equal(got[~exempt], want[~exempt])
    assert float((got != want).float().mean()) <= 1e-3
    err3 = (got_min.double() - want_min).abs().max().item()
    err1 = (emulate_tiles(x, m, plan, passes=1)[0].double() - want_min).abs().max().item()
    assert err3 <= MIN_TOL
    assert err1 > MIN_TOL and err1 >= 10 * err3


def test_merge_gives_the_lexicographic_minimum_with_signed_zeros_equal():
    """Parked (distance, index) pairs of three ranges (indices 0-9, 10-19,
    20-29), each already its range's lowest index on ties: negative
    distances, −0.0 against +0.0 both ways, equal distances across ranges."""
    rows = [
        [(-1.0, 3), (-1.0, 12), (0.5, 25)],  # equal negatives: the lower index
        [(0.0, 4), (-0.0, 11), (0.0, 20)],  # +0.0 first, −0.0 later: equal, index 4
        [(-0.0, 9), (0.0, 10), (-0.0, 29)],  # −0.0 first: index 9
        [(2.0, 0), (1.0, 19), (1.0, 21)],  # the lower distance, then the lower index
        [(3.0, 1), (3.0, 15), (-2.5, 22)],  # a later range wins only by a lower distance
        [(float("inf"), 0), (float("inf"), 10), (7.0, 27)],
    ]
    parts = [
        (torch.tensor([r[k][0] for r in rows]), torch.tensor([r[k][1] for r in rows]))
        for k in range(3)
    ]
    best, arg = merge_parked(parts)
    for i, r in enumerate(rows):
        v, a = min(r)  # Python's tuple order: lexicographic, and −0.0 == 0.0
        assert arg[i].item() == a and best[i].item() == v
    assert arg.tolist() == [3, 4, 9, 19, 22, 27]
