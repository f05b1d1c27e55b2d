"""The port's RMSNorm and decode-attention ops against the reference.

On the CPU each port wrapper runs its plain version; it is held against the
reference's jnp oracle and its Pallas op in interpret mode (as the reference
package's own tests run it), on the same numpy inputs. The CUDA kernels
themselves run only on a card: tests/test_torch_gpu.py holds them against
their plain versions there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jx_dec_ops
from repro.kernels.decode_attention import ref as jx_dec_ref
from repro.kernels.rmsnorm import ops as jx_rms_ops
from repro.kernels.rmsnorm import ref as jx_rms_ref
from repro.models import layers as jx_layers
from repro_torch.configs import all_configs
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import layers

# The reference's own tolerances (tests/test_extensions.py, tests/test_kernels.py):
# f32 sums in different orders differ by a few ulps of O(1) values; a bf16
# output may round one step apart (2^-8 relative, 0.03 at |y| near 4-8).
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
DEC_TOL = 2e-5
DEC_TOL_BF16_CACHE = 3e-2

RMS_CASES = [
    ((4, 7, 96), torch.float32),
    ((33, 1024), torch.bfloat16),
    ((2, 3, 5, 130), torch.float32),
    ((8, 8), torch.float32),
]


def _rms_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, s


def _jnp(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("case", range(len(RMS_CASES)))
def test_rmsnorm_matches_reference_op_and_oracle(case):
    shape, dtype = RMS_CASES[case]
    x, s = _rms_inputs(shape, case)
    got = rms_ops.rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(s).to(dtype))
    assert got.dtype == dtype and got.shape == shape
    pallas = jx_rms_ops.rms_norm(_jnp(x, dtype), _jnp(s, dtype))  # interpret mode here
    oracle = jx_rms_ref.rms_norm(_jnp(x, dtype), _jnp(s, dtype))
    for want in (pallas, oracle):
        err = np.abs(got.float().numpy() - np.asarray(want).astype(np.float32)).max()
        assert err < RMS_TOL[dtype], (shape, dtype, err)


def test_rmsnorm_bf16_rows_with_f32_scale_match_the_zoo_norm():
    """The zoo's case: a bf16 residual stream, f32 scales, as
    ``repro.models.layers.rms_norm`` computes it."""
    x, s = _rms_inputs((6, 256), 7)
    got = layers.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(s))
    want = jx_layers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want).astype(np.float32)).max()
    assert err < RMS_TOL[torch.bfloat16]


def test_rmsnorm_honours_eps_where_the_reference_op_drops_it():
    x, s = _rms_inputs((5, 64), 3)
    x *= 1e-3  # mean(x²) ~ 1e-6: eps matters
    got = rms_ops.rms_norm(torch.from_numpy(x), torch.from_numpy(s), eps=1e-4)
    want = jx_rms_ref.rms_norm(jnp.asarray(x), jnp.asarray(s), eps=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    dropped = jx_rms_ops.rms_norm(jnp.asarray(x), jnp.asarray(s), eps=1e-4)  # uses 1e-6
    assert np.abs(np.asarray(dropped) - np.asarray(want)).max() > 1e-2


def _dec_inputs(b, h, hkv, s, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    return q, k, v


DEC_SHAPES = [(2, 8, 2, 128, 64), (1, 16, 16, 300, 128), (3, 12, 4, 1024, 32), (2, 4, 1, 77, 80)]


@pytest.mark.parametrize("shape", DEC_SHAPES)
def test_decode_attention_matches_reference_op(shape):
    q, k, v = _dec_inputs(*shape, seed=sum(shape))
    got = dec_ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jx_dec_ops.decode_attention(q, k, v)  # the Pallas op, interpret mode
    assert got.dtype == torch.float32 and got.shape == shape[:2] + shape[4:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DEC_TOL, rtol=DEC_TOL)


def test_decode_attention_bf16_cache_matches_reference_op():
    q, k, v = _dec_inputs(2, 8, 2, 256, 64, seed=0)
    kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    got = dec_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    )
    want = jx_dec_ops.decode_attention(q, kb, vb)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=DEC_TOL_BF16_CACHE, rtol=DEC_TOL_BF16_CACHE
    )


@pytest.mark.parametrize("shape", DEC_SHAPES[:2] + [(4, 24, 8, 48, 128)])
def test_decode_attention_lengths_and_zoo_layout_match_the_oracle(shape):
    """Ragged per-sequence lengths, with the caches handed over as the zoo's
    (B, S, Hkv, dh) tensors viewed as (B, Hkv, S, dh)."""
    b, h, hkv, s, dh = shape
    q, k, v = _dec_inputs(*shape, seed=1)
    lengths = np.random.default_rng(2).integers(1, s + 1, b).astype(np.int32)
    lengths[0] = 1
    want = jx_dec_ref.decode_attention(q, k, v, lengths=jnp.asarray(lengths))
    zoo_k, zoo_v = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))) for a in (k, v))
    got = dec_ops.decode_attention(
        torch.from_numpy(q), zoo_k.transpose(1, 2), zoo_v.transpose(1, 2), torch.from_numpy(lengths)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DEC_TOL, rtol=DEC_TOL)
    full = dec_ref.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    all_valid = dec_ops.decode_attention(
        torch.from_numpy(q), zoo_k.transpose(1, 2), zoo_v.transpose(1, 2), torch.full((b,), s)
    )
    torch.testing.assert_close(all_valid, full, atol=DEC_TOL, rtol=DEC_TOL)


def _np_decode_mask_attention(q, k, v, key_pos, q_pos, lengths=None):
    """The decode branch of ``repro.models.layers.attention_apply`` in
    float64 numpy: every slot scored, -1e30 where its stored position fails
    ``(pos_q - (kpos - 1) >= 0) & (kpos > 0)`` (and, if given, where the
    oracle's ``lengths`` end the row), softmax, P·V."""
    b, h, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qf = (q.astype(np.float64) / math.sqrt(dh)).reshape(b, hkv, h // hkv, dh)
    scores = np.einsum("bkgd,bksd->bkgs", qf, k.astype(np.float64))
    dpos = q_pos[:, None] - (key_pos - 1)
    mask = (dpos >= 0) & (key_pos > 0)
    if lengths is not None:
        mask &= np.arange(s)[None, :] < lengths[:, None]
    scores = np.where(mask[:, None, None, :], scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgs,bksd->bkgd", p, v.astype(np.float64)).reshape(b, h, dh), mask


def _positions(b, s, rng, lengths=None):
    """Stored positions (+1, 0 = empty) in no order along the slots, a
    query position per sequence, and one slot per sequence (inside its
    length) holding the query's own position, as the current token's does."""
    q_pos = rng.integers(0, s, b).astype(np.int32)
    key_pos = rng.integers(0, s + 1, (b, s)).astype(np.int32)
    key_pos[rng.random((b, s)) < 0.2] = 0
    limit = lengths if lengths is not None else np.full(b, s)
    cur = (rng.random(b) * limit).astype(np.int64)
    key_pos[np.arange(b), cur] = q_pos + 1
    return key_pos, q_pos


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("shape", DEC_SHAPES[:2] + [(4, 24, 8, 48, 128)])
def test_decode_attention_position_mask_matches_the_reference_decode_mask(shape, with_lengths):
    """Valid slots that are no prefix, alone and together with lengths,
    with the caches in the zoo's layout viewed as (B, Hkv, S, dh)."""
    b, h, hkv, s, dh = shape
    q, k, v = _dec_inputs(*shape, seed=3)
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, s + 1, b).astype(np.int32) if with_lengths else None
    key_pos, q_pos = _positions(b, s, rng, lengths)
    want, mask = _np_decode_mask_attention(q, k, v, key_pos, q_pos, lengths)
    n = mask.sum(-1)
    prefix = [mask[i, : n[i]].all() for i in range(b)]
    assert not all(prefix) and mask.any(-1).all()
    zoo_k, zoo_v = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))) for a in (k, v))
    got = dec_ops.decode_attention(
        torch.from_numpy(q),
        zoo_k.transpose(1, 2),
        zoo_v.transpose(1, 2),
        None if lengths is None else torch.from_numpy(lengths),
        key_pos=torch.from_numpy(key_pos),
        q_pos=torch.from_numpy(q_pos),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=DEC_TOL, rtol=DEC_TOL)


def test_decode_step_passes_stored_positions_and_no_lengths(monkeypatch):
    """The zoo's decode branch hands the kernel the cache's stored positions
    and the query's, after writing this token's, and counts nothing."""
    b, h, hkv, s, dh = 2, 4, 2, 6, 8
    seen = {}

    def record(q, k_cache, v_cache, lengths=None, key_pos=None, q_pos=None, window=None):
        seen.update(lengths=lengths, key_pos=key_pos.clone(), q_pos=q_pos.clone(), window=window)
        return torch.zeros(q.shape)

    monkeypatch.setattr(layers.decode_ops, "decode_attention", record)
    cache = {
        "k": torch.zeros(b, s, hkv, dh),
        "v": torch.zeros(b, s, hkv, dh),
        "pos": torch.tensor([[5, 0, 0, 0, 0, 0], [2, 0, 0, 0, 0, 0]], dtype=torch.int32),
        "index": torch.tensor(1, dtype=torch.int32),
    }
    positions = torch.tensor([[3], [0]], dtype=torch.int32)
    out = layers._decode_attend(
        torch.zeros(b, 1, h, dh), torch.ones(b, 1, hkv, dh), torch.ones(b, 1, hkv, dh),
        positions, cache,
    )
    assert out.shape == (b, 1, h, dh) and seen["lengths"] is None and seen["window"] is None
    assert seen["key_pos"].tolist() == [[5, 4, 0, 0, 0, 0], [2, 1, 0, 0, 0, 0]]
    assert seen["q_pos"].tolist() == [3, 0] and int(cache["index"]) == 2


def test_wrappers_check_inputs_and_never_fall_back(monkeypatch):
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="scale must be"):
        rms_ops.rms_norm(x, torch.ones(7))
    with pytest.raises(TypeError, match="floating point"):
        rms_ops.rms_norm(x.long(), torch.ones(8))
    q, k = torch.zeros(2, 6, 16), torch.zeros(2, 4, 10, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        dec_ops.decode_attention(q, k, k)
    with pytest.raises(ValueError, match="lengths"):
        dec_ops.decode_attention(q, k[:, :2], k[:, :2], torch.ones(3, dtype=torch.int32))
    kv = k[:, :2]
    pos, qpos = torch.ones(2, 10, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="come together"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos)
    with pytest.raises(ValueError, match="come together"):
        dec_ops.decode_attention(q, kv, kv, q_pos=qpos)
    with pytest.raises(ValueError, match="key_pos must be"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos[:, :9], q_pos=qpos)
    with pytest.raises(ValueError, match="q_pos must be"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos, q_pos=qpos[:1])
    with pytest.raises(ValueError, match="integer"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos.float(), q_pos=qpos)
    with pytest.raises(ValueError, match="integer"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos, q_pos=qpos.bool())
    with pytest.raises(ValueError, match="q_pos is on meta"):
        dec_ops.decode_attention(q, kv, kv, key_pos=pos, q_pos=qpos.to("meta"))
    # any device other than the CPU launches the kernel or raises
    monkeypatch.setattr(dec_ref, "decode_attention", lambda *a: pytest.fail("plain route taken"))
    meta = torch.zeros(2, 6, 16, device="meta")
    with pytest.raises(ValueError, match="no decode-attention route"):
        dec_ops.decode_attention(meta, meta.new_zeros(2, 2, 10, 16), meta.new_zeros(2, 2, 10, 16))
    with pytest.raises(ValueError, match="no decode-attention route"):
        dec_ops.decode_attention(
            meta,
            meta.new_zeros(2, 2, 10, 16),
            meta.new_zeros(2, 2, 10, 16),
            key_pos=pos.to("meta"),
            q_pos=qpos.to("meta"),
        )
    with pytest.raises(ValueError, match="no RMSNorm route"):
        rms_ops.rms_norm(torch.zeros(3, 8, device="meta"), torch.ones(8, device="meta"))


def test_kernels_are_registered_for_the_build():
    assert {"rmsnorm", "decode_attention"} <= set(_build.KERNELS)
    for name in ("rmsnorm", "decode_attention"):
        assert _build.library_path(name).name.startswith(name + "-")


@pytest.mark.parametrize(
    "shape, sms, ragged, want",
    [
        ((4, 24, 8, 48, 128), 132, False, 1),  # the zoo's decode step: one range, no merge kernel
        ((8, 24, 8, 32768, 128), 132, False, 4),  # long context at B = 8: one full wave of blocks
        ((8, 24, 8, 32768, 128), 132, True, 16),  # with lengths: four waves to balance them
        ((1, 16, 16, 4096, 256), 132, False, 8),  # no range shorter than 512 keys
        ((2, 4, 1, 77, 80), 132, False, 1),
    ],
)
def test_decode_attention_split_policy(shape, sms, ragged, want):
    """The launch plan's key ranges, and every key in one range and one warp."""
    b, h, hkv, s, dh = shape
    # 255 registers a thread: the most the kernel's __launch_bounds__(128, 1) allows
    plan = dec_ops.launch_plan(b, hkv, h // hkv, s, dh, 2, sms, 255, ragged)
    assert plan.splits == want
    assert plan.blocks == b * hkv * dec_ops.head_blocks(h // hkv) * want
    covered = np.zeros(s, np.int64)
    for lo, hi in plan.ranges(s):
        for warp in range(plan.warps):
            for k0, k1 in plan.warp_tiles(lo, hi, warp):
                covered[k0:k1] += 1
    assert (covered == 1).all()


def _row_counts(rows, rows_per_block, blocks):
    """How often the kernel's block-strided loop visits each row."""
    counts = np.zeros(rows, np.int64)
    base = np.arange(blocks) * rows_per_block
    while (base < rows).any():
        r = (base[base < rows][:, None] + np.arange(rows_per_block)).ravel()
        np.add.at(counts, r[r < rows], 1)
        base = base + blocks * rows_per_block
    return counts


def _element_counts(threads_per_row, vpt, d, v, a):
    """How often the slots of a row's threads (thread t: slots t + j·tpr,
    j < vpt; slot k: elements k·V - a ... k·V - a + V - 1) cover each
    element of a row that starts a elements past a 16-byte boundary."""
    k = np.arange(threads_per_row * vpt)
    c = (k[:, None] * v - a + np.arange(v)).ravel()
    return np.bincount(c[(c >= 0) & (c < d)], minlength=d)


SMS = 132  # an H100's SMs


@pytest.mark.parametrize(
    "rows, d, dtype",
    [
        (4, 3072, torch.bfloat16),  # the zoo's decode step
        (128, 3072, torch.bfloat16),  # its 32-token prompt at batch 4
        (2048, 4096, torch.float32),  # the reference op's own example
        (2048, 4096, torch.bfloat16),
        (231, 130, torch.float32),  # odd d: rows start off the 16-byte grid
        (264, 3071, torch.float32),  # 768 threads, a row off the grid spans 769 vectors
        (4, 16384, torch.bfloat16),  # the widest config (llama3-405b)
        (4, 1536, torch.bfloat16),  # granite-moe's decode step
        (4, 1024, torch.bfloat16),  # mamba2's
        (4, 2048, torch.bfloat16),  # zamba2's
        (4, 2048, torch.float32),  # mamba2's gated norm (d_inner, f32)
        (4, 4096, torch.float32),  # zamba2's gated norm
        (128, 4096, torch.float32),  # zamba2's gated norm over a 32-token prompt
        (5000, 96, torch.float32),  # narrow rows share a block
    ],
)
def test_rmsnorm_launch_shape_covers_each_element_once_from_registers(rows, d, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    v = 16 // itemsize
    threads, rows_per_block, blocks = rms_ops.launch_shape(rows, d, itemsize, SMS)
    assert 32 <= threads <= 1024 and threads % 32 == 0 and threads % rows_per_block == 0
    tpr = threads // rows_per_block
    assert tpr % 32 == 0 and 1 <= blocks <= rms_ops.MAX_BLOCKS
    assert (_row_counts(rows, rows_per_block, blocks) == 1).all()
    for aligned in (True, False):
        vpt = rms_ops.vectors_per_thread(tpr, d, itemsize, aligned)
        assert vpt in (1, 2, 4)  # resident: every shape here is promised registers
        offsets = [0] if aligned and d % v == 0 else range(v)
        for a in offsets:
            assert (_element_counts(tpr, vpt, d, v, a) == 1).all(), (aligned, a)
    if rows <= 2 * SMS:  # few rows: a block per row, a vector a thread where it fits
        assert (rows_per_block, blocks) == (1, rows)
        slots = -(-d // v)
        assert threads == min(1024, 32 * -(-slots // 32))
    else:
        assert rows_per_block * blocks >= rows or blocks == rms_ops.MAX_BLOCKS


def test_rmsnorm_launch_shape_at_the_decode_step():
    """4 rows of 3072 bf16: 4 blocks of 384 threads, one vector each."""
    assert rms_ops.launch_shape(4, 3072, 2, SMS) == (384, 1, 4)
    assert rms_ops.vectors_per_thread(384, 3072, 2, True) == 1
    assert rms_ops.vectors_per_thread(384, 3072, 2, False) == 2  # an offset view
    assert rms_ops.vectors_per_thread(1024, 40000, 4, True) == 0  # too wide: the loop


@pytest.mark.parametrize("name", sorted(all_configs()))
def test_every_config_norm_runs_from_registers(name):
    d = all_configs()[name].d_model
    for dtype in (torch.float32, torch.bfloat16):
        itemsize = torch.finfo(dtype).bits // 8
        for rows in (4, 128, 8192):
            threads, rows_per_block, _ = rms_ops.launch_shape(rows, d, itemsize, SMS)
            assert rms_ops.vectors_per_thread(threads // rows_per_block, d, itemsize, True) > 0


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-1.2b"])
def test_mamba_gated_norm_runs_from_registers(name):
    """The gated norm runs in f32 at d_inner (2048 and 4096)."""
    cfg = all_configs()[name]
    d = cfg.ssm.expand * cfg.d_model
    assert d == {"mamba2-370m": 2048, "zamba2-1.2b": 4096}[name]
    for rows in (4, 128, 8192):
        threads, rows_per_block, _ = rms_ops.launch_shape(rows, d, 4, SMS)
        assert rms_ops.vectors_per_thread(threads // rows_per_block, d, 4, True) > 0
