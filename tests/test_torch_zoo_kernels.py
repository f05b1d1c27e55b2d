"""The port's RMSNorm and decode-attention ops against the reference.

On the CPU each port wrapper runs its plain version; it is held against the
reference's jnp oracle and its Pallas op in interpret mode (as the reference
package's own tests run it), on the same numpy inputs. The CUDA kernels
themselves run only on a card: tests/test_torch_gpu.py holds them against
their plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jx_dec_ops
from repro.kernels.decode_attention import ref as jx_dec_ref
from repro.kernels.rmsnorm import ops as jx_rms_ops
from repro.kernels.rmsnorm import ref as jx_rms_ref
from repro.models import layers as jx_layers
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
    # any device other than the CPU launches the kernel or raises
    monkeypatch.setattr(dec_ref, "decode_attention", lambda *a: pytest.fail("plain route taken"))
    meta = torch.zeros(2, 6, 16, device="meta")
    with pytest.raises(ValueError, match="no decode-attention route"):
        dec_ops.decode_attention(meta, meta.new_zeros(2, 2, 10, 16), meta.new_zeros(2, 2, 10, 16))
    with pytest.raises(ValueError, match="no RMSNorm route"):
        rms_ops.rms_norm(torch.zeros(3, 8, device="meta"), torch.ones(8, device="meta"))


def test_kernels_are_registered_for_the_build():
    assert {"rmsnorm", "decode_attention"} <= set(_build.KERNELS)
    for name in ("rmsnorm", "decode_attention"):
        assert _build.library_path(name).name.startswith(name + "-")


@pytest.mark.parametrize(
    "shape, sms, want",
    [
        ((4, 8, 48), 132, 1),  # the zoo's decode step: one block per (b, kv head)
        ((8, 8, 32768), 132, 5),  # long context at B = 8: ~2 blocks per SM
        ((1, 16, 4096), 132, 8),  # capped at 8 tiles (512 keys) a range
        ((2, 1, 77), 132, 1),
    ],
)
def test_decode_attention_split_policy(shape, sms, want):
    assert dec_ops.num_splits(*shape, sms) == want
