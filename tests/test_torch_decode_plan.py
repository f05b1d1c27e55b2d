"""The decode-attention kernel's launch plan and split, held on the CPU.

The CUDA kernel (``kernels/decode_attention/csrc/decode_attention.cu``) runs
only on a card. What can be held here:

* the plan (``ops.launch_plan``): at every ``chip_smoke.py`` decode shape
  and at edge lengths of the cache, each key lies in exactly one key range
  and, inside it, in exactly one warp's tiles; the zoo's decode step is one
  range; a 32k-key cache fills the card (132 SMs on an H100) with one wave
  of blocks, and with per-sequence lengths takes at least two blocks an SM;
  shared memory and the parked sums stay within their limits; the blocks
  an SM holds are bounded by shared memory, threads, registers and 32;
* that loading the library checks this module's copy of the kernel's
  geometry (the plan counts with it) against the kernel's own, and reads
  each instantiation's registers;
* the kernel's split, emulated in torch in f32: each warp's online softmax
  over its own tiles, the block's merge of its warps, the merge of the
  ranges, ranges past a sequence's length skipped and ranges whose keys
  are all masked weighed 0. It agrees with the float64 plain version
  within the card tests' 2e-5, with lengths and positions.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402

H100_SMS = 132
REGS = 255  # the most registers a thread may take under the kernel's __launch_bounds__(128, 1)
TOL = 2e-5  # tests/test_torch_gpu.py's limit for the kernel against f64
NEG = -1e30  # the reference's masked score
DECODE_STEP = (4, 24, 8, 48, 128)
LONG = (8, 24, 8, 32768, 128)
EDGE_SHAPES = [(4, 24, 8, s, 128) for s in (1, 63, 64, 65, 32768)]


def _coverage(plan, s, length=None):
    """How often the plan's ranges and their warps' tiles visit each key
    below ``length`` (all S by default), as the kernel walks them."""
    length = s if length is None else length
    covered = np.zeros(s, np.int64)
    for lo, hi in plan.ranges(s):
        if lo >= length:  # the block exits at once
            continue
        for warp in range(plan.warps):
            for k0, k1 in plan.warp_tiles(lo, min(hi, length), warp):
                assert 0 < k1 - k0 <= ops.KT
                covered[k0:k1] += 1
    return covered


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize(
    "shape", [row[:5] for row in chip_smoke.DECODE_SHAPES] + EDGE_SHAPES, ids=str
)
def test_plan_puts_every_key_in_one_range_and_one_warp(shape, elem, ragged):
    b, h, hkv, s, dh = shape
    plan = ops.launch_plan(b, hkv, h // hkv, s, dh, elem, H100_SMS, REGS, ragged)
    ranges = plan.ranges(s)
    assert len(ranges) == plan.splits >= 1
    assert plan.blocks == b * hkv * ops.head_blocks(h // hkv) * plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == s and all(lo < hi for lo, hi in ranges)
    # the C entry's rule for a plan: every range holds a key of S
    assert plan.range_keys % ops.KT == 0
    assert (plan.splits - 1) * plan.range_keys < s <= plan.splits * plan.range_keys
    assert 1 <= plan.warps <= ops.MAX_WARPS
    assert plan.smem == ops.smem_bytes(dh, elem, h // hkv, plan.warps)
    assert plan.smem <= ops.MAX_SMEM
    assert (_coverage(plan, s) == 1).all()
    for length in (1, s // 3 + 1, s):  # ragged lengths: keys past len[b] are never visited
        covered = _coverage(plan, s, length)
        assert (covered[:length] == 1).all() and not covered[length:].any()


def _slots(plan):
    """Blocks the card holds at once under a plan."""
    return H100_SMS * ops.blocks_per_sm(plan.smem, plan.warps, REGS)


@pytest.mark.parametrize("ragged", [False, True])
def test_plan_is_one_range_at_the_decode_step_and_fills_the_card_at_32k(ragged):
    b, h, hkv, s, dh = DECODE_STEP
    step = ops.launch_plan(b, hkv, h // hkv, s, dh, 2, H100_SMS, REGS, ragged)
    assert step.splits == 1 and step.warps == 3  # 48 keys: three tiles, one warp each
    b, h, hkv, s, dh = LONG
    long = ops.launch_plan(b, hkv, h // hkv, s, dh, 2, H100_SMS, REGS, ragged)
    assert long.range_keys >= ops.MIN_RANGE_KEYS
    if ragged:  # several waves: blocks that end early are replaced by waiting ones
        assert long.blocks >= 2 * H100_SMS and long.blocks > 2 * _slots(long)
    else:  # one wave, short of the card's slots by less than one more range's blocks
        assert _slots(long) - b * hkv < long.blocks <= _slots(long)
    # the parked sums stay small against the cache the ranges read
    parked = ops.parked_bytes(b, h, dh, long.splits)
    assert parked <= ops.PARK_SHARE * 2 * b * hkv * s * dh * 2


@pytest.mark.parametrize("ragged, splits", [(False, 4), (True, 7)])
def test_plan_at_g16_takes_one_wave_unless_lengths_are_given(ragged, splits):
    """llama3-405b's head layout (G = 16: two blocks of 8 heads per kv head)
    at 4096 keys: without lengths one wave of 4 ranges of 1024 keys (on an
    H100 it measured faster than the two-wave plan of 7 ranges, which
    per-sequence lengths ask for so that the scheduler balances them)."""
    b, h, hkv, s, dh = 4, 128, 8, 4096, 128
    plan = ops.launch_plan(b, hkv, h // hkv, s, dh, 2, H100_SMS, REGS, ragged)
    assert plan.splits == splits and plan.warps == ops.MAX_WARPS
    waves = -(-plan.blocks // _slots(plan))
    assert waves == (2 if ragged else 1)


@pytest.mark.parametrize(
    "smem, warps, regs, blocks",
    [
        (106_752, 4, 126, 2),  # G = 3, dh = 128 in bf16: shared memory binds
        (20_000, 4, 203, 2),  # G = 8's 203 registers: 208 a thread, 9 warps an SM
        (20_000, 4, 126, 4),  # 128 registers a thread: 16 warps an SM
        (1_000, 4, 24, 16),  # 2048 threads an SM
        (1_000, 1, 32, 32),  # at most 32 blocks an SM
        (1_000, 1, 255, 8),  # 256 registers a thread, 8 warps an SM
    ],
)
def test_blocks_an_sm_holds(smem, warps, regs, blocks):
    assert ops.blocks_per_sm(smem, warps, regs) == blocks


@pytest.mark.parametrize(
    "dh, elem", [(8, 2), (64, 2), (128, 2), (256, 2), (4, 4), (64, 4), (128, 4), (256, 4)]
)
@pytest.mark.parametrize("g", [1, 3, 16])
def test_every_head_width_and_group_fits_shared_memory(dh, elem, g):
    plan = ops.launch_plan(2, 4, g, 4096, dh, elem, H100_SMS, REGS, False)
    assert plan.smem <= ops.MAX_SMEM
    # each warp's ring holds the warp's (acc, m, l) for the block's merge
    ring = ops.STAGES * (2 * ops.KT * ops.row_pitch(dh, elem) + ops.KT * 4)
    assert 4 * (g * dh + 2 * ops.padded_group(g)) <= ring
    # an odd number of 16-byte chunks between staged rows: no bank conflicts
    assert ops.row_pitch(dh, elem) % 32 == 16 and ops.row_pitch(dh, elem) >= dh * elem


class _FakeLibrary:
    """Stands in for the built library's ``decode_attention_geometry``, which
    fills KT, MAX_WARPS, STAGES, MAX_G, MAX_DH and the shared bytes at (dh,
    elem, G, warps), and its ``decode_attention_registers``, which gives an
    instantiation's registers a thread or -cudaError_t."""

    def __init__(self, regs=lambda elem, g: 64 + 16 * g + elem, **changed):
        self.changed = changed

        def query(dh, elem, g, warps, out):
            geo = dict(KT=ops.KT, MAX_WARPS=ops.MAX_WARPS, STAGES=ops.STAGES)
            geo.update(MAX_G=ops.MAX_GROUP, MAX_DH=ops.MAX_HEAD_DIM)
            geo["smem"] = ops.smem_bytes(dh, elem, g, warps)
            geo.update(self.changed)
            for i, value in enumerate(geo.values()):
                out[i] = value

        self.decode_attention_geometry = query
        self.decode_attention_registers = regs


@pytest.mark.parametrize(
    "changed", [{}, {"KT": 32}, {"MAX_WARPS": 8}, {"smem": 1}, {"STAGES": 4}], ids=str
)
def test_loading_checks_the_plan_geometry_against_the_kernel(changed):
    if not changed:
        ops._check_geometry(_FakeLibrary())
        return
    with pytest.raises(RuntimeError, match="geometry"):
        ops._check_geometry(_FakeLibrary(**changed))


def test_loading_reads_each_instantiations_registers():
    regs = ops._read_registers(_FakeLibrary())
    assert regs == {(e, g): 64 + 16 * g + e for e in (2, 4) for g in (1, 2, 3, 4, 8)}
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        ops._read_registers(_FakeLibrary(regs=lambda elem, g: -98 if g == 8 else 100))


def emulate(q, k, v, plan, lengths=None, key_pos=None, q_pos=None, parts_out=None):
    """The kernel's split in f32 on (B, H, dh) q and (B, Hkv, S, dh) caches:
    per (sequence, kv head), each range below len[b] runs its warps, warp w
    walking its tiles with the online softmax of the G heads (masked keys
    score -1e30; a warp or range with no valid key keeps m = -1e30); the
    block merges its warps, and the ranges are merged, those past len[b]
    skipped. ``parts_out``, a list, collects each range's (m, l)."""
    b, h, dh = q.shape
    _, hkv, s, _ = k.shape
    g = h // hkv
    # q carries log2(e) / sqrt(dh), rounded once to f32: scores in log2 units
    qs = q.float() * torch.tensor(math.log2(math.e) / math.sqrt(dh), dtype=torch.float32)
    out = torch.empty(b, h, dh)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp2(p[0] - m) for p in parts]
        l_ = sum(p[1] * wi for p, wi in zip(parts, w))
        acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
        return m, l_, acc

    for bi in range(b):
        length = s if lengths is None else min(int(lengths[bi]), s)
        valid = torch.ones(s, dtype=torch.bool)
        if key_pos is not None:
            valid = (key_pos[bi] > 0) & (key_pos[bi] - 1 <= q_pos[bi])
        for kh in range(hkv):
            qg = qs[bi, kh * g : (kh + 1) * g]
            ranges = []
            for lo, hi in plan.ranges(s):
                if lo >= length:
                    continue
                warps = []
                for warp in range(plan.warps):
                    m = torch.full((g,), NEG)
                    l_ = torch.zeros(g)
                    acc = torch.zeros(g, dh)
                    for k0, k1 in plan.warp_tiles(lo, min(hi, length), warp):
                        sc = qg @ k[bi, kh, k0:k1].float().T
                        sc = torch.where(valid[k0:k1], sc, torch.tensor(NEG))
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l_ = l_ * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ v[bi, kh, k0:k1].float()
                        m = m_new
                    warps.append((m, l_, acc))
                ranges.append(merge(warps))
                if parts_out is not None:
                    parts_out.append((bi, kh, lo, ranges[-1][0], ranges[-1][1]))
            _, l_, acc = merge(ranges)
            out[bi, kh * g : (kh + 1) * g] = acc / l_[:, None]
    return out


def _inputs(b, h, hkv, s, dh, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    # the zoo's (B, S, Hkv, dh) cache viewed as (B, Hkv, S, dh)
    k, v = (
        torch.from_numpy(rng.standard_normal((b, s, hkv, dh)).astype(np.float32))
        .to(dtype)
        .transpose(1, 2)
        for _ in range(2)
    )
    return q, k, v


_oracle64 = chip_smoke.decode_oracle64


def test_oracle_is_the_plain_version_in_float64():
    b, h, hkv, s, dh = 2, 6, 2, 40, 16
    q, k, v = _inputs(b, h, hkv, s, dh, seed=6)
    lengths = torch.tensor([17, 40], dtype=torch.int32)
    key_pos = torch.from_numpy(np.random.default_rng(7).integers(0, s + 1, (b, s)).astype(np.int32))
    q_pos = torch.tensor([30, 39])
    key_pos[:, 3] = q_pos + 1
    got = _oracle64(q, k, v, lengths, key_pos, q_pos)
    assert got.dtype == torch.float64
    want = ref.decode_attention(q, k, v, lengths, key_pos, q_pos)
    assert (got - want.double()).abs().max().item() <= 1e-6


@pytest.mark.parametrize("want", [1, 3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matches_f64_with_lengths(want, dtype):
    """Several ranges and warps; the ragged lengths leave the last ranges of
    some sequences empty (never run, skipped by the merge)."""
    b, h, hkv, s, dh = 3, 6, 2, 300, 32
    q, k, v = _inputs(b, h, hkv, s, dh, seed=1, dtype=dtype)
    plan = ops.split_plan(b, hkv, h // hkv, s, dh, k.element_size(), H100_SMS, want)
    assert plan.splits >= want
    lengths = torch.tensor([1, 77, 300], dtype=torch.int32)
    got = emulate(q, k, v, plan, lengths)
    want64 = _oracle64(q, k, v, lengths)
    assert (got.double() - want64).abs().max().item() <= TOL


@pytest.mark.parametrize("want", [1, 4])
def test_split_matches_f64_with_positions_and_masked_ranges(want):
    """Positions in no order along the slots; in sequence 0 every key of the
    first half of the cache fails the mask, so whole tiles, warps and ranges
    hold no valid key: they keep m = -1e30 and the merges weigh them 0."""
    b, h, hkv, s, dh = 2, 8, 2, 256, 48
    q, k, v = _inputs(b, h, hkv, s, dh, seed=2)
    rng = np.random.default_rng(3)
    q_pos = rng.integers(s // 2, s, b)
    key_pos = rng.integers(0, s + 1, (b, s))
    key_pos[0, : s // 2] = np.where(rng.random(s // 2) < 0.5, 0, s + 1)  # empty or later
    key_pos[np.arange(b), rng.integers(s // 2, s, b)] = q_pos + 1  # the current token's slot
    key_pos, q_pos = torch.from_numpy(key_pos.astype(np.int32)), torch.from_numpy(q_pos)
    lengths = torch.tensor([s, s - 5], dtype=torch.int32)
    plan = ops.split_plan(b, hkv, h // hkv, s, dh, 4, H100_SMS, want)
    parts = []
    got = emulate(q, k, v, plan, lengths, key_pos, q_pos, parts)
    want64 = _oracle64(q, k, v, lengths, key_pos, q_pos)
    assert (got.double() - want64).abs().max().item() <= TOL
    if want > 1:  # sequence 0's first two ranges saw only masked keys
        masked = [p for p in parts if p[0] == 0 and p[2] < s // 2]
        assert masked and all(bool((p[3] == NEG).all()) and bool((p[4] > 0).all()) for p in masked)


def test_split_of_the_wrapper_plan_at_the_decode_step_matches_f64():
    """The zoo's decode-step plan (one range, three warps of one tile) at
    phi4-mini's shape, bf16 caches, the path's position mask."""
    b, h, hkv, s, dh = DECODE_STEP
    q, k, v = _inputs(b, h, hkv, s, dh, seed=4, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    q_pos = torch.from_numpy(rng.integers(0, s, b))
    key_pos = torch.from_numpy(rng.integers(0, s + 1, (b, s)).astype(np.int32))
    key_pos[torch.arange(b), torch.from_numpy(rng.integers(0, s, b))] = (q_pos + 1).int()
    plan = ops.launch_plan(b, hkv, h // hkv, s, dh, 2, H100_SMS, REGS, False)
    got = emulate(q, k, v, plan, key_pos=key_pos, q_pos=q_pos)
    assert (got.double() - _oracle64(q, k, v, None, key_pos, q_pos)).abs().max().item() <= TOL


@pytest.mark.parametrize("shape", [(4, 24, 8, 48, 64), (4, 32, 32, 48, 64)], ids=["G3", "G1"])
def test_split_of_the_wrapper_plan_at_the_families_decode_steps_matches_f64(shape):
    """granite-moe's decode step (G = 3) and zamba2's shared block (G = 1)
    at dh 64: one range of three warps, bf16 caches, the path's mask."""
    b, h, hkv, s, dh = shape
    q, k, v = _inputs(b, h, hkv, s, dh, seed=6, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    q_pos = torch.from_numpy(rng.integers(0, s, b))
    key_pos = torch.from_numpy(rng.integers(0, s + 1, (b, s)).astype(np.int32))
    key_pos[torch.arange(b), torch.from_numpy(rng.integers(0, s, b))] = (q_pos + 1).int()
    plan = ops.launch_plan(b, hkv, h // hkv, s, dh, 2, H100_SMS, REGS, False)
    assert plan.splits == 1 and plan.warps == 3
    assert plan.blocks == b * hkv
    got = emulate(q, k, v, plan, key_pos=key_pos, q_pos=q_pos)
    assert (got.double() - _oracle64(q, k, v, None, key_pos, q_pos)).abs().max().item() <= TOL
