"""The port's Eq. 10 SDPA estimator against the reference.

On the CPU the port's wrapper runs its plain version; it is held against the
reference's jnp oracle (``repro.kernels.sdpa_estimator.ref``) and the
reference's Pallas op in interpret mode, on the same numpy inputs. The CUDA
kernel itself runs only on a card: tests/test_torch_gpu.py holds it against
the plain version there.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import estimator as jx_estimator
from repro.engine import dispatch as jx_dispatch
from repro.kernels.sdpa_estimator import ops as jx_ops
from repro.kernels.sdpa_estimator import ref as jx_ref
from repro_torch.core import estimator
from repro_torch.engine import dispatch
from repro_torch.kernels import _build
from repro_torch.kernels.sdpa_estimator import ops, ref

# f32 throughout; the two sides sum the d-long dot products and the N_o-long
# softmax in different orders, a few ulps on O(1) outputs. The reference's
# own kernel tests hold its Pallas op to its oracle at the same 2e-5.
TOL = 2e-5

CASES = {
    "batched": (3, 37, 50, 16, 16),
    "ragged_no": (1, 20, 129, 8, 8),
    "d_ne_db": (2, 9, 17, 12, 20),
}


def _inputs(b, nu, no, d, db, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, nu, d)).astype(np.float32),
        rng.standard_normal((b, no, d)).astype(np.float32),
        rng.standard_normal((b, no, db)).astype(np.float32),
    )


def _port(fn, *arrays):
    return fn(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_reference_oracle_and_pallas_op(case):
    q, a, b = _inputs(*CASES[case])
    got = _port(ops.sdpa_estimate_batched, q, a, b)
    oracle = np.asarray(jax.vmap(jx_ref.sdpa_estimate)(q, a, b))
    pallas = np.asarray(jx_ops.sdpa_estimate_batched(q, a, b))  # interpret mode here
    assert got.shape == oracle.shape == (CASES[case][0], CASES[case][1], CASES[case][4])
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)


def test_width1_matches_reference_op():
    q, a, b = (x[0] for x in _inputs(1, 33, 70, 24, 10, seed=1))
    got = _port(ops.sdpa_estimate, q, a, b)
    np.testing.assert_allclose(got, np.asarray(jx_ops.sdpa_estimate(q, a, b)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _port(ref.sdpa_estimate, q, a, b), atol=0, rtol=0)


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = ops.LAUNCHES
    q, a, b = (torch.from_numpy(x) for x in _inputs(2, 5, 7, 4, 4))
    ops.sdpa_estimate_batched(q, a, b)
    ops.sdpa_estimate(q[0], a[0], b[0])
    assert ops.LAUNCHES == before


def test_inputs_cast_to_float32():
    q, a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(1, 6, 9, 8, 8))
    out = ops.sdpa_estimate_batched(q, a, b)
    assert out.dtype == torch.float32
    want = ref.sdpa_estimate_batched(q.float(), a.float(), b.float())
    torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "shapes,match",
    [
        (((5, 4), (1, 7, 4), (1, 7, 4)), "must be"),  # rank
        (((1, 5, 4), (1, 7, 3), (1, 7, 4)), "width"),  # d mismatch
        (((1, 5, 4), (1, 7, 4), (1, 6, 4)), "rows"),  # N_o mismatch
        (((2, 5, 4), (1, 7, 4), (1, 7, 4)), "batch"),  # B mismatch
        (((1, 5, 4), (1, 0, 4), (1, 0, 4)), "empty"),  # no overlap rows
        (((1, 5, 300), (1, 7, 300), (1, 7, 4)), "d=300"),  # too wide
        (((1, 5, 4), (1, 7, 4), (1, 7, 257)), "d_b=257"),
    ],
)
def test_wrapper_rejects_bad_inputs(shapes, match):
    with pytest.raises(ValueError, match=match):
        ops.sdpa_estimate_batched(*(torch.zeros(s) for s in shapes))


def test_wrapper_rejects_strided_inner_dim_and_ints():
    q = torch.zeros(1, 5, 8)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.sdpa_estimate_batched(q, torch.zeros(1, 7, 4), torch.zeros(1, 7, 4))
    with pytest.raises(TypeError, match="floating"):
        ops.sdpa_estimate_batched(
            torch.zeros(1, 5, 4, dtype=torch.int32), torch.zeros(1, 7, 4), torch.zeros(1, 7, 4)
        )


def test_estimator_functions_match_reference():
    q, a, b = _inputs(2, 11, 13, 6, 9, seed=3)
    np.testing.assert_allclose(
        _port(estimator.sdpa_transform, q[0], a[0], b[0]),
        np.asarray(jx_estimator.sdpa_transform(q[0], a[0], b[0])),
        atol=TOL,
        rtol=TOL,
    )
    np.testing.assert_allclose(
        _port(estimator.sdpa_transform_batched, q, a, b),
        np.asarray(jx_estimator.sdpa_transform_batched(q, a, b)),
        atol=TOL,
        rtol=TOL,
    )


@pytest.mark.parametrize("widths", [(6, 6, 6), (6, 5, 7)])
def test_estimate_missing_fused_matches_reference(widths, monkeypatch):
    """K = 3: equal widths take ONE batched call of width 2; ragged widths
    take one width-1 call per missing party. Both match the reference."""
    rng = np.random.default_rng(4)
    h_u = rng.standard_normal((10, widths[1])).astype(np.float32)
    h_o = [rng.standard_normal((14, w)).astype(np.float32) for w in widths]
    k = 1
    widths_seen = []
    real = ops.sdpa_estimate_batched

    def counting(q, a, b):
        widths_seen.append(q.shape[0])
        return real(q, a, b)

    monkeypatch.setattr(ops, "sdpa_estimate_batched", counting)
    got = dispatch.estimate_missing_fused(
        torch.from_numpy(h_u), [torch.from_numpy(h) for h in h_o], k
    )
    assert widths_seen == ([2] if len(set(widths)) == 1 else [1, 1])
    want = jx_dispatch.estimate_missing_fused(h_u, h_o, k, use_kernels=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
