"""The Eq. 10 kernel's launch plan and arithmetic, held on the CPU.

The CUDA kernel (``kernels/sdpa_estimator/csrc/sdpa_estimator.cu``) runs only
on a card. What can be held here:

* the key-range plan (``ops.launch_plan``): at every ``chip_smoke.py`` shape
  and at edge cases, its ranges cover each key exactly once, none is empty,
  the serving shape has at least a block an SM (132 on an H100) and the
  few-shot step ③' shape one range;
* that loading the library checks this module's copy of the kernel's
  geometry (the plan counts with it) against the kernel's own;
* the kernel's arithmetic, emulated in torch: operands split into TF32
  hi + lo (rounded bit for bit as ``cvt.rna`` rounds, on the int32 view),
  the products taken as hi·hi + hi·lo + lo·hi over BN-key tiles with the
  online softmax, each tile's P·v added to acc in f32 as the kernel adds
  it, each key range parking (acc, m, l) and the merge rescaling them. The
  sums inside a product are IEEE f32 here, not the tensor cores' own
  accumulation, so only the rounding is the kernel's exactly. It agrees
  with the float64 plain version within the card tests' 2e-5 at the serving
  shape, where a single TF32 pass errs at least ten times more: the reason
  the kernel takes three.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch import scenarios  # noqa: E402
from repro_torch.kernels.sdpa_estimator import ops, ref  # noqa: E402

H100_SMS = 132
TOL = 2e-5  # tests/test_torch_gpu.py's limit for the kernel against f64
SERVING = (1, 1024, 2048, 128, 128)
STEP3_FEW_SHOT = (1, 22976, 2048, 128, 128)
EDGE_SHAPES = [
    (1, 1024, 1, 128, 128),
    (1, 1024, 7, 128, 128),
    (1, 1024, 8, 128, 128),
    (1, 1024, 9, 128, 128),
    (1, 1024, 2049, 128, 128),
    (1, 1, 2048, 128, 128),
    (1, 15, 2048, 3, 1),
    (2, 17, 517, 200, 256),
    (65535, 1, 33, 8, 8),
]




def _catalog_shapes():
    """Few-shot step ③''s launch on every catalog scenario at its registered
    sizes, as (B, N_u, N_o, d, d_b): a party's K − 1 estimates of its pool
    rows over the N_o keys (a padded split's capacity), rep d. The pool
    sizes follow make_vfl_partition: 20 % test rows, the aligned block,
    the rest dealt evenly (0 at full overlap)."""
    out = []
    for name in scenarios.names():
        spec = scenarios.get(name)
        n_o = spec.overlap_capacity or spec.overlap
        rest = spec.num_samples - int(spec.num_samples * 0.2)
        k = spec.num_parties
        out.append((k - 1, (rest - n_o) // k, n_o, spec.rep_dim, spec.rep_dim))
    return list(dict.fromkeys(out))


CATALOG_SHAPES = _catalog_shapes()


@pytest.mark.parametrize(
    "shape", chip_smoke.SHAPES + EDGE_SHAPES + CATALOG_SHAPES, ids=str
)
def test_plan_covers_every_key_once(shape):
    b, nu, no, d, db = shape
    plan = ops.launch_plan(b, nu, no, d, db, H100_SMS)
    ranges = plan.ranges(no)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == no
    assert all(lo < hi for lo, hi in ranges)  # no range is empty
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))  # contiguous
    covered = np.zeros(no, dtype=np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the kernel's own validity rule for the range count
    step = plan.per_tiles * ops.BN
    assert (plan.splits - 1) * step < no <= plan.splits * step
    row_blocks = b * math.ceil(nu / ops.BM) * math.ceil(db / ops.COLS)
    assert plan.blocks == row_blocks * plan.splits


def test_plan_fills_the_card_at_serving_and_keeps_one_range_at_step3():
    serving = ops.launch_plan(*SERVING, H100_SMS)
    assert serving.blocks >= H100_SMS and serving.splits > 1
    assert ops.launch_plan(*STEP3_FEW_SHOT, H100_SMS).splits == 1
    # K = 4: three estimates a launch
    assert ops.launch_plan(3, 1024, 2048, 128, 128, H100_SMS).blocks >= H100_SMS


def test_catalog_shapes_include_the_widest_launch_and_an_empty_pool():
    assert (7, 164, 128, 8, 8) in CATALOG_SHAPES  # credit/parties-8
    assert (3, 76, 96, 32, 32) in CATALOG_SHAPES  # image/patch-4
    assert (1, 0, 800, 16, 16) in CATALOG_SHAPES  # edge/full-overlap
    assert [s for s, _ in chip_smoke.CATALOG_SDPA_SHAPES] == [
        (7, 164, 128, 8, 8), (1, 1184, 32, 16, 16)
    ]
    empty = ops.launch_plan(1, 0, 800, 16, 16, H100_SMS)
    assert empty.blocks == 0 and empty.splits == 1  # nothing to launch


@pytest.mark.parametrize("shape", [(7, 164, 128, 8, 8), (3, 76, 96, 32, 32)], ids=str)
def test_fused_step3p_views_reach_the_kernel_without_a_copy(shape):
    """③' broadcasts h_u and H_oᴬ over the K − 1 estimates as stride-0
    views and stacks the value matrices: TMA reads all three in place (the
    batch stride 0 and rows of d floats, a multiple of 4, pass the wrapper's
    rule), and the wrapper's checks accept them."""
    b, nu, no, d, db = shape
    h_u, h_o = torch.randn(nu, d), torch.randn(no, d)
    q, a = h_u.expand(b, nu, d), h_o.expand(b, no, d)
    v = torch.stack([torch.randn(no, db) for _ in range(b)])
    ops._check(q, a, v)
    for t in (q, a, v):
        assert ops._tma_view(t) is t
    assert ops._strides(q) == (0, d) and ops._strides(a) == (0, d)


class _FakeLibrary:
    """Stands in for the built library's ``sdpa_estimator_geometry``, which
    fills BM, BN, COLS, BOX, MAX_D, MIN_BLOCKS and the shared bytes at (d, db)."""

    def __init__(self, **changed):
        self.changed = changed

        def query(d, db, out):
            g = dict(BM=ops.BM, BN=ops.BN, COLS=ops.COLS, BOX=ops.BOX, MAX_D=ops.MAX_WIDTH)
            g.update(MIN_BLOCKS=ops.MIN_BLOCKS, smem=ops.smem_bytes(d, db))
            g.update(self.changed)
            for i, value in enumerate(g.values()):
                out[i] = value

        self.sdpa_estimator_geometry = query


@pytest.mark.parametrize(
    "changed", [{}, {"BN": 64}, {"MIN_BLOCKS": 3}, {"smem": 1}, {"MAX_D": 128}], ids=str
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


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel forms it: 3xTF32 (the two cross terms, then hi·hi)
    or one TF32 pass."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def emulate(q, k, v, plan, passes=3, empty_ranges=0):
    """The kernel's Eq. 10 on (N_u, d), (N_o, d), (N_o, d_b) f32 inputs: each
    key range walks its BN-key tiles with the online softmax and parks
    (acc, m, l); the merge rescales them to the common max. ``empty_ranges``
    appends ranges that saw no valid key (m = -inf, l = 0, acc = 0)."""
    qs = q * (1.0 / math.sqrt(q.shape[-1]))  # scale in f32 before the split
    parts = []
    for lo, hi in plan.ranges(k.shape[0]):
        m = torch.full((q.shape[0], 1), -math.inf)
        l_ = torch.zeros(q.shape[0], 1)
        acc = torch.zeros(q.shape[0], v.shape[1])
        for k0 in range(lo, hi, ops.BN):
            k1 = min(hi, k0 + ops.BN)
            s = product(qs, k[k0:k1].T, passes)
            m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l_ = l_ * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + product(p, v[k0:k1], passes)
            m = m_new
        parts.append((acc, m, l_))
    for _ in range(empty_ranges):
        parts.append((torch.zeros_like(parts[0][0]), torch.full_like(m, -math.inf), 0 * l_))
    m_all = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m_all) for p in parts]
    l_all = sum(p[2] * wi for p, wi in zip(parts, w))
    return sum(p[0] * wi for p, wi in zip(parts, w)) / l_all


def oracle64(q, k, v):
    """Eq. 10 in float64 (``ref`` casts its inputs to f32)."""
    q, k, v = q.double(), k.double(), v.double()
    return torch.softmax((q @ k.T) / math.sqrt(q.shape[-1]), dim=-1) @ v


def _inputs(nu, no, d, db, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((nu, d), (no, d), (no, db))
    )


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0**-10  # TF32's step in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23, 1.0 + 1.5 * ulp])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp])
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([math.pi]))
    assert abs((hi + lo).item() - math.pi) < 2**-21 and abs(lo.item()) <= 2**-10


def test_3xtf32_over_the_plan_matches_f64_where_one_pass_does_not():
    b, nu, no, d, db = SERVING
    q, k, v = _inputs(nu, no, d, db)
    plan = ops.launch_plan(b, nu, no, d, db, H100_SMS)
    assert plan.splits > 1
    want = oracle64(q, k, v)
    assert (ref.sdpa_estimate(q, k, v).double() - want).abs().max().item() <= TOL
    err3 = (emulate(q, k, v, plan).double() - want).abs().max().item()
    err1 = (emulate(q, k, v, plan, passes=1).double() - want).abs().max().item()
    assert err3 <= TOL
    assert err1 >= 10 * err3


@pytest.mark.parametrize("shape", [(1, 15, 2049, 24, 40), (2, 17, 9, 3, 1)], ids=str)
def test_merge_weighs_a_range_with_no_valid_key_zero(shape):
    b, nu, no, d, db = shape
    q, k, v = _inputs(nu, no, d, db, seed=1)
    plan = ops.split_plan(b, nu, no, db, H100_SMS, want=5)
    want = oracle64(q, k, v)
    got = emulate(q, k, v, plan)
    assert torch.equal(emulate(q, k, v, plan, empty_ranges=2), got)
    assert (got.double() - want).abs().max().item() <= TOL


# The folds' ③' launches: hard/overlap-32 and -64 at S = 4 (one launch of
# width 4 a party), the fault family's few-shot group folded over C = 9
# (width 27 = 9 entries × the K − 1 = 3 estimates).
FOLD_SHAPES = [(4, 1184, 32, 16, 16), (4, 1168, 64, 16, 16), (27, 592, 32, 16, 16)]


# (ranges, blocks) the wrapper's plan makes at each: one 32-key tile cannot
# split; at 64 keys and 76 row blocks two ranges fill more of the card; at
# width 27 the query rows alone give every SM a block
FOLD_PLANS = {FOLD_SHAPES[0]: (1, 76), FOLD_SHAPES[1]: (2, 152), FOLD_SHAPES[2]: (1, 270)}


@pytest.mark.parametrize("shape", FOLD_SHAPES, ids=str)
def test_fold_shapes_are_planned_and_covered(shape):
    """At the folded widths every key is covered once by a whole number of
    tiles, and the plan is the cost model's (FOLD_PLANS)."""
    b, nu, no, d, db = shape
    plan = ops.launch_plan(b, nu, no, d, db, H100_SMS)
    ranges = plan.ranges(no)
    assert ranges[0][0] == 0 and ranges[-1][1] == no
    assert all(a[1] == b_[0] and a[0] < a[1] for a, b_ in zip(ranges, ranges[1:]))
    row_blocks = b * math.ceil(nu / ops.BM) * math.ceil(db / ops.COLS)
    assert plan.blocks == row_blocks * plan.splits
    assert (plan.splits, plan.blocks) == FOLD_PLANS[shape]
    assert [s for s, _ in chip_smoke.FOLD_SDPA_SHAPES] == [FOLD_SHAPES[0], FOLD_SHAPES[2]]
