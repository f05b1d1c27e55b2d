"""The RMSNorm backward kernel's split and summation order, held on the CPU.

The CUDA kernel (``rmsnorm_bwd_*`` in ``kernels/rmsnorm/csrc/rmsnorm.cu``)
runs only on a card. What can be held here:

* the split (``ops.backward_plan``): at every ``chip_smoke.py`` backward
  shape, at (3, 7), (1, 1), (300, 16384), at the widest row the first
  version's shared-memory accumulator took (57984) and one past it, and at
  300 odd widths, each in f32 and bf16, every row lies in exactly one
  block's group and every column in exactly one thread's slot; blocks are
  whole warps within the route's thread limit, at most one an SM; a
  register-route group holds the row's slots, and wider rows take the loop
  route; the groups' sums fit the kernel's static shared memory; the
  column sum's blocks cover d;
* the order every column's dscale is summed in (``sum_tree``): each row
  once, the same for every column;
* the kernel's arithmetic, emulated in torch in f32 on the split: each
  thread's partial sums over its slots, the warp's butterfly, the group's
  warps, dx rounded once, each group's dscale terms in its rows' order, the
  block's tree over its groups, and the column sum's warps. It agrees with
  a float64 oracle within the card tests' bounds (dx 1e-5 of its largest
  entry, plus one bf16 step in bf16; dscale 1e-5 of its largest).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.kernels.rmsnorm import ops  # noqa: E402

H100_SMS = 132
SOURCE = Path(ops.__file__).parent / "csrc" / "rmsnorm.cu"
SHAPES = [(r, d) for r, d, _ in chip_smoke.RMS_BWD_SHAPES]
EXTRA = [(3, 7), (1, 1), (300, 16384), (5, 57984), (5, 57985), (1024, 4096), (1024, 8192)]
ODD_WIDTHS = list(range(1, 600, 2))
TOL = chip_smoke.RMS_BWD_TOL


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _check_split(rows, d, itemsize, split, max_blocks=H100_SMS, default=True):
    v = 16 // itemsize
    slots = -(-d // v)
    tpr, g = split.group_threads, split.groups
    # whole warps, within the route's limit, at most one block an SM
    assert tpr % 32 == 0 and 32 <= tpr and split.threads <= ops.MAX_THREADS
    assert split.threads <= ops.backward_max_threads(split.vpt)
    assert 1 <= split.blocks <= max_blocks and 1 <= split.sum_warps <= 32
    if tpr > 32:
        assert g <= ops.BWD_MAX_BARRIER_GROUPS  # one named barrier a group
    # a register route's group holds the row's slots; wider rows loop
    if slots > ops.BWD_MAX_SLOTS:
        assert split.vpt == 0 and g == 1
    else:
        assert split.vpt in (1, 2, 4) and tpr * split.vpt >= slots
        assert split.vpt * v <= 16 or not default  # at most 16 elements a thread by default
    # the groups' parked sums fit the kernel's static comb array
    per_thread = max(split.vpt, 1) * v
    assert (g // 2) * tpr * per_thread <= ops.backward_max_threads(split.vpt) // 2 * per_thread
    # every block has a row, every row a block, in whole rounds of the groups
    assert split.rows_per_block % g == 0
    assert (split.blocks - 1) * split.rows_per_block < rows <= split.blocks * split.rows_per_block
    seen = np.zeros(rows, np.int64)
    for b in range(split.blocks):
        for grp in range(g):
            for r in split.group_rows(rows, b, grp):
                seen[r] += 1
    assert (seen == 1).all()
    # every column in one thread's slot
    cols = np.zeros(slots * v, np.int64)
    for t in range(tpr):
        for k in split.thread_slots(slots, t):
            cols[k * v : k * v + v] += 1
    assert (cols == 1).all()
    # the column sum: ceil(d / 32) blocks of 32 columns, the partial rows dealt to its warps
    assert -(-d // 32) * 32 >= d > (-(-d // 32) - 1) * 32
    warps = split.sum_warps
    dealt = sorted(b for w in range(warps) for b in range(w, split.blocks, warps))
    assert dealt == list(range(split.blocks))


def _leaves(tree):
    if isinstance(tree, range):
        return list(tree)
    if isinstance(tree, list) and all(isinstance(t, int) for t in tree):
        return tree
    return [r for t in tree for r in _leaves(t)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows, d", SHAPES + EXTRA, ids=str)
def test_split_visits_every_row_and_column_once(rows, d, itemsize):
    split = ops.backward_plan(rows, d, itemsize, H100_SMS)
    _check_split(rows, d, itemsize, split)
    order = split.sum_tree(rows)
    assert sorted(_leaves(order)) == list(range(rows))
    assert order == split.sum_tree(rows)  # one fixed order, whatever the data


@pytest.mark.parametrize("d", ODD_WIDTHS)
def test_split_at_odd_widths(d):
    for itemsize in (2, 4):
        rows = 1 + (d * 37) % 1500
        _check_split(rows, d, itemsize, ops.backward_plan(rows, d, itemsize, H100_SMS))


@pytest.mark.parametrize("vpt", [1, 2, 4])
@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8, 15])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_overridden_splits_stay_in_the_kernels_limits(vpt, groups, per_sm):
    """The [plan] rows' splits: any override keeps every row and column
    covered once, clamped to the route's threads (blocks may then be two
    an SM)."""
    for rows, d, itemsize in ((1024, 1024, 2), (1024, 2048, 4), (231, 130, 4)):
        split = ops.backward_plan(rows, d, itemsize, H100_SMS, vpt, groups, per_sm)
        if split.threads > ops.backward_max_threads(split.vpt):  # the [plan] rows skip these
            continue
        _check_split(rows, d, itemsize, split, per_sm * H100_SMS, default=False)


def test_the_training_shapes_take_the_measured_splits():
    """mamba2's block norms, its gated norms and phi4-mini's: 128 blocks of
    8 rows, two rows a group (PERF.md section 6)."""
    want = {
        (1024, 1024, 2): (2, 64, 4),
        (1024, 2048, 4): (4, 128, 2),
        (1024, 3072, 2): (2, 192, 2),
    }
    for (rows, d, itemsize), (vpt, tpr, groups) in want.items():
        split = ops.backward_plan(rows, d, itemsize, H100_SMS)
        assert (split.vpt, split.group_threads, split.groups) == (vpt, tpr, groups)
        assert (split.blocks, split.rows_per_block, split.sum_warps) == (128, 8, 32)


def test_the_column_sum_takes_the_splits_warps_as_a_dependent_launch():
    """The C entry derives the column sum's warps from the blocks as
    ``BackwardSplit.sum_warps`` does, and always launches it as a
    programmatic dependent of the row pass."""
    src = SOURCE.read_text()
    assert "warps = blocks < MAX_WARPS ? blocks : MAX_WARPS;" in src
    assert "cfg.numAttrs = 1;" in src
    assert src.count("griddepcontrol.wait;") == 1 and src.count("griddepcontrol.launch_dependents;") == 1
    for blocks in (1, 5, 31, 32, 33, 128, 1 << 16):
        assert ops.BackwardSplit(1, 32, 1, blocks, 1).sum_warps == min(32, blocks)


def test_the_static_shared_memory_matches_the_source():
    """The row pass's two static arrays, read from the CUDA source, stay
    within the 48 KB of static shared memory for every route and x type;
    none grows with d."""
    src = SOURCE.read_text()
    assert "__shared__ float red[2][2][MAX_WARPS];" in src
    assert "__shared__ float4 comb[VPT > 0 ? bwd_max_threads(VPT) / 2 * R * V / 4 : 1];" in src
    assert "return vpt <= 1 ? MAX_THREADS : MAX_THREADS / vpt;" in src  # bwd_max_threads
    for vpt in (0, 1, 2, 4):
        for v in (4, 8):
            comb = 16 * (ops.backward_max_threads(vpt) // 2 * vpt * v // 4 if vpt else 1)
            assert comb + 2 * 2 * 32 * 4 <= 48 * 1024


# ---- the kernel's arithmetic, emulated on its split


def _butterfly(a: torch.Tensor) -> torch.Tensor:
    """The warp's xor-shuffle sum over the last axis (32 lanes): every lane
    ends with the same bits."""
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., torch.arange(32) ^ o]
    return a[..., 0]


def _group_sums(per_thread: torch.Tensor, tpr: int) -> torch.Tensor:
    """(rows, tpr) thread partials → (rows,) group totals: each warp's
    butterfly, then the group's warp totals (zero-padded to 32 lanes)
    through one more butterfly when the group has several warps."""
    rows = per_thread.shape[0]
    warps = _butterfly(per_thread.reshape(rows, tpr // 32, 32))
    if tpr == 32:
        return warps[:, 0]
    lanes = torch.zeros(rows, 32)
    lanes[:, : tpr // 32] = warps
    return _butterfly(lanes)


def emulate(x, scale, dy, split, eps=1e-6):
    """(dx, dscale) as the kernel computes them under ``split``, in f32."""
    rows, d = x.shape
    v = 16 // x.element_size()
    slots = -(-d // v)
    tpr = split.group_threads
    per = split.vpt or -(-slots // tpr)  # slots a thread: the loop route walks as many
    width = per * tpr * v
    pad = lambda a: torch.nn.functional.pad(a.float(), (0, width - d))  # noqa: E731
    # element (slot k = t + j tpr, i) of a row → [j, t, i]
    xs, gs = pad(x).reshape(rows, per, tpr, v), pad(dy).reshape(rows, per, tpr, v)
    ss_t, dot_t = torch.zeros(rows, tpr), torch.zeros(rows, tpr)
    sc = pad(scale[None])[0].reshape(per, tpr, v)
    for j in range(per):
        for i in range(v):
            xv, g = xs[:, j, :, i], gs[:, j, :, i]
            ss_t = ss_t + xv * xv
            dot_t = dot_t + xv * (sc[j, :, i] * g)
    ss, dot = _group_sums(ss_t, tpr), _group_sums(dot_t, tpr)
    inv = torch.rsqrt(ss / d + eps)
    k3 = inv * inv * inv * (dot / d)
    gf, xf = pad(dy), pad(x)
    dx = (inv[:, None] * (pad(scale[None]) * gf) - xf * k3[:, None])[:, :d].to(x.dtype)
    term = (gf * xf) * inv[:, None]  # fmaf(g * x, inv, acc): one rounding of the product here
    partials = []
    for b in range(split.blocks):
        acc = {}
        for g in range(split.groups):
            a = torch.zeros(width)
            for r in split.group_rows(rows, b, g):
                a = a + term[r]
            acc[g] = a
        for level in split.combine_levels():
            for g, partner in level:
                acc[g] = acc[g] + acc[partner]
        partials.append(acc[0])
    warp_sums = []
    for w in range(split.sum_warps):
        s = torch.zeros(width)
        for b in range(w, split.blocks, split.sum_warps):
            s = s + partials[b]
        warp_sums.append(s)
    total = torch.zeros(width)
    for s in warp_sums:
        total = total + s
    return dx, total[:d].to(scale.dtype)


@pytest.mark.parametrize(
    "rows, d, dtype, scale_dtype",
    [(r, d, dt, torch.float32) for r, d, dt in chip_smoke.RMS_BWD_SHAPES]
    + [
        (3, 7, torch.float32, torch.float32),
        # one row: at d = 1, dx = r s dy eps / (x^2 + eps) is the difference of two
        # nearly equal terms, which no f32 arithmetic (the plain version's
        # neither) gets within 1e-5; the split at (1, 1) is held above
        (1, 8, torch.bfloat16, torch.float32),
        (300, 16384, torch.float32, torch.float32),
        (40, 130, torch.bfloat16, torch.bfloat16),
    ],
    ids=str,
)
def test_emulated_split_matches_f64(rows, d, dtype, scale_dtype):
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    scale = torch.from_numpy(scale).to(scale_dtype)
    split = ops.backward_plan(rows, d, x.element_size(), H100_SMS)
    dx, ds = emulate(x, scale, dy, split)
    want_dx, want_ds = chip_smoke._bwd_oracle64(x, scale.float(), dy)
    assert bool(((dx.double() - want_dx).abs() <= chip_smoke.bwd_dx_bound(want_dx, dtype)).all())
    tol_ds = TOL if scale_dtype == torch.float32 else 2**-7
    assert (ds.double() - want_ds).abs().max() <= tol_ds * want_ds.abs().max()
    # the summation order is the split's, not the data's: the same bits again
    again = emulate(x, scale, dy, split)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])


@pytest.mark.parametrize("rows, d, dtype", chip_smoke.RMS_BWD_SHAPES, ids=str)
def test_chip_smoke_backward_bound_counts_each_byte_once(rows, d, dtype):
    """x and dy read and dx written once in x's type, the f32 scale read and
    dscale written once, over the card's memory rate; the training shapes
    are bound by bytes."""
    x = torch.empty(rows, d, dtype=dtype)
    nbytes, bound_ms, bound_by = chip_smoke.bwd_bound(x)
    assert nbytes == 3 * rows * d * x.element_size() + 8 * d
    ops_ms = 12 * rows * d / chip_smoke.H100_F32_FLOPS * 1e3
    assert bound_ms == max(nbytes / chip_smoke.H100_BYTES_PER_S * 1e3, ops_ms)
    assert bound_by == ("bytes" if nbytes / chip_smoke.H100_BYTES_PER_S * 1e3 > ops_ms else "operations")
    if rows == 1024:
        assert bound_by == "bytes"
