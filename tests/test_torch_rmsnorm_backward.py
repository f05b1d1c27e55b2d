"""The RMSNorm backward's plain version and the op's autograd route on the CPU.

``ref.rms_norm_backward`` is the explicit formula the CUDA backward
computes. It is held to ``torch.autograd`` of ``ref.rms_norm`` and to
``jax.grad`` of the reference's ``repro.models.layers.rms_norm`` (the norm
the reference trains through) on the same numpy inputs, in f32 within 1e-5
of each gradient's largest entry (sums in different orders); in f64 by
``gradcheck`` through ``ops.rms_norm`` at ``test_torch_zoo_kernels.py``'s
shapes (its fast mode, the Jacobian against random projections, at all of
them; the full Jacobian where it is small: at 33 × 1024 it takes minutes);
and with bf16 x and f32 scale, dx within one bf16 step of the f32
formula's. The CUDA kernel itself runs only on a card
(``tests/test_torch_gpu.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jx_layers
from repro_torch.kernels.rmsnorm import ops, ref

TOL = 1e-5
SHAPES = [(4, 7, 96), (33, 1024), (2, 3, 5, 130), (8, 8)]  # test_torch_zoo_kernels.RMS_CASES
EPS = (1e-6, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, s, dy


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_and_jax_grad(shape, eps):
    x, s, dy = _inputs(shape, len(shape) + int(eps * 1e6))
    dx, ds = ref.rms_norm_backward(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(dy), eps)
    assert dx.dtype == torch.float32 and ds.shape == s.shape

    xt, st = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(s).requires_grad_(True)
    ref.rms_norm(xt, st, eps).backward(torch.from_numpy(dy))
    _close(dx, xt.grad)
    _close(ds, st.grad)

    def jloss(xj, sj):
        return jnp.sum(jx_layers.rms_norm(xj, sj, eps) * jnp.asarray(dy))

    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    _close(dx, jdx)
    _close(ds, jds)


@pytest.mark.parametrize("shape", SHAPES)
def test_op_gradcheck_in_float64(shape):
    """The op's autograd Function, forward and backward through the plain
    versions (f64 arithmetic for f64 inputs), against finite differences."""
    x, s, _ = _inputs(shape, 11)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    st = torch.from_numpy(s).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: ops.rms_norm(a, b, 1e-6), (xt, st), fast_mode=True)
    if xt.numel() <= 1024:  # and the full Jacobian where it is small
        assert torch.autograd.gradcheck(lambda a, b: ops.rms_norm(a, b, 1e-6), (xt, st))


def test_op_under_grad_takes_the_function_and_counts_no_cpu_launch():
    x, s, dy = _inputs((6, 40), 3)
    before = (ops.LAUNCHES, ops.BACKWARD_LAUNCHES)
    xt, st = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(s).requires_grad_(True)
    y = ops.rms_norm(xt, st)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("RmsNormFunction")
    y.backward(torch.from_numpy(dy))
    dx, ds = ref.rms_norm_backward(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(dy))
    assert torch.equal(xt.grad, dx) and torch.equal(st.grad, ds)
    assert (ops.LAUNCHES, ops.BACKWARD_LAUNCHES) == before  # the CPU launches nothing
    with torch.no_grad():
        assert ops.rms_norm(xt, st).grad_fn is None  # the short path with grad off


def test_only_the_inputs_that_need_it_get_a_gradient():
    x, s, dy = _inputs((5, 24), 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s)
    ops.rms_norm(xt, st).backward(torch.from_numpy(dy))
    assert xt.grad is not None and st.grad is None
    st = torch.from_numpy(s).requires_grad_(True)
    ops.rms_norm(torch.from_numpy(x), st).backward(torch.from_numpy(dy))
    assert st.grad is not None


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_bf16_rows_round_dx_once_to_one_bf16_step(scale_dtype):
    """bf16 x (and dy) with an f32 or bf16 scale: dx is the f32 formula
    rounded once to bf16 (within one bf16 step of it), dscale in scale's
    dtype; the same as autograd of the plain forward."""
    x, s, dy = _inputs((64, 256), 5)
    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    sb = torch.from_numpy(s).to(scale_dtype)
    dx, ds = ref.rms_norm_backward(xb, sb, dyb)
    assert dx.dtype == torch.bfloat16 and ds.dtype == scale_dtype
    dx32, ds32 = ref.rms_norm_backward(xb.float(), sb.float(), dyb.float())
    step = torch.exp2(torch.floor(torch.log2(dx32.abs().clamp_min(2.0**-126))) - 7)
    assert bool(((dx.float() - dx32).abs() <= step).all())
    np.testing.assert_allclose(ds.float().numpy(), ds32.to(scale_dtype).float().numpy())
    xt, st = xb.clone().requires_grad_(True), sb.clone().requires_grad_(True)
    ops.rms_norm(xt, st).backward(dyb)
    assert torch.equal(xt.grad, dx) and torch.equal(st.grad, ds)
    jx = jax.grad(lambda a: jnp.sum(jx_layers.rms_norm(a, jnp.asarray(s)).astype(jnp.float32)
                                    * jnp.asarray(dyb.float().numpy())))
    jdx = np.asarray(jx(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    if scale_dtype == torch.float32:
        assert np.abs(dx.float().numpy() - jdx).max() <= 2 * step.max().item()


def test_backward_under_activation_checkpointing():
    """The Function under non-reentrant checkpointing: the recomputed
    forward feeds the same backward."""
    from torch.utils.checkpoint import checkpoint

    x, s, dy = _inputs((7, 48), 6)
    grads = []
    for remat in (False, True):
        xt, st = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(s).requires_grad_(True)

        def f(a):
            return ops.rms_norm(torch.tanh(a), st) * 2.0

        y = checkpoint(f, xt, use_reentrant=False) if remat else f(xt)
        y.backward(torch.from_numpy(dy))
        grads.append((xt.grad, st.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_backward_checks_its_inputs():
    x, s = torch.zeros(3, 8), torch.ones(8)
    with pytest.raises(ValueError, match="dy must match"):
        ops.rms_norm_backward(x, s, torch.zeros(3, 7))
    with pytest.raises(ValueError, match="dy must match"):
        ops.rms_norm_backward(x, s, torch.zeros(3, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="scale must be"):
        ops.rms_norm_backward(x, torch.ones(7), x)
    meta = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="no RMSNorm backward route"):
        ops.rms_norm_backward(meta, torch.ones(8, device="meta"), meta)
    dx, ds = ops.rms_norm_backward(torch.zeros(0, 8), s, torch.zeros(0, 8))
    assert dx.shape == (0, 8) and torch.equal(ds, torch.zeros(8))


@pytest.mark.parametrize("rows, d", [(1024, 1024), (1024, 2048), (1024, 3072), (512, 256), (3, 130), (1, 1)])
def test_backward_shape(rows, d):
    """The wrapper's split in f32 and bf16: groups of whole warps, at most
    1024 threads a block (fewer at more slots a thread), at most one block
    an SM and never more blocks than rows (each block writes one partial
    row of dscale), every block's rows whole rounds of its groups, and a
    group that holds its row's 16-byte slots."""
    for itemsize in (2, 4):
        split = ops.backward_plan(rows, d, itemsize, 132)
        assert split.group_threads % 32 == 0
        assert split.threads <= ops.backward_max_threads(split.vpt)
        assert split.blocks <= min(rows, 132) and split.rows_per_block % split.groups == 0
        assert split.group_threads * split.vpt >= -(-d // (16 // itemsize))


def test_backward_width_limit_leaves_room_for_the_static_slots():
    """No width is refused: past ``BWD_MAX_SLOTS`` slots a row takes the
    loop route, whose dscale terms go to its partial row in the scratch,
    so the row pass's shared memory is its static slots alone (the
    reduction's red[2][2][MAX_WARPS] floats and the groups' parked sums,
    comb, within the 48 KB a block may take statically) at every width,
    the first version's widest (57984, its d-float accumulator beside the
    slots filling 227 KB) and past it."""
    src = (Path(ops.__file__).parent / "csrc" / "rmsnorm.cu").read_text()
    assert "__shared__ float red[2][2][MAX_WARPS];" in src
    rows_kernel = src.split("rmsnorm_bwd_rows_kernel")[1].split("rmsnorm_bwd_scale_kernel")[0]
    assert "extern __shared__" not in rows_kernel
    assert not hasattr(ops, "MAX_BACKWARD_D")
    for d in (ops.BWD_MAX_SLOTS * 4, ops.BWD_MAX_SLOTS * 4 + 1, 57984, 57985, 1 << 20):
        split = ops.backward_plan(5, d, 4, 132)
        assert split.vpt == (0 if d > ops.BWD_MAX_SLOTS * 4 else 4)
        static = 2 * 2 * (ops.MAX_THREADS // 32) * 4
        parked = ops.backward_max_threads(split.vpt) // 2 * split.vpt  # threads x slots, 4 floats
        comb = 16 * (parked if split.vpt else 1)
        assert static + comb <= 48 * 1024
