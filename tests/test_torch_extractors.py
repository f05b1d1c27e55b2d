"""The port's extractors and heads against ``repro.models.extractors``.

Parameters take the key structure and shapes of the reference's own init
(``jax.eval_shape``) and seeded numpy values, so biases and GroupNorm affine
terms are non-trivial; they cross through ``repro_torch.bridge``. Inputs are
numpy draws from a seed handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import extractors as jx
from repro_torch import bridge
from repro_torch.models import extractors as tx

# Dense layers are a handful of f32 dot products: both sides agree to the
# last few ulps.
DENSE_TOL = 1e-5
# The CNN chains up to 9 convolutions and GroupNorms; the two frameworks
# sum each 3x3xC window and each group's variance in a different order, and
# every GroupNorm rescales those rounding differences by 1/std, so f32
# outputs drift by a few ulps per layer. Relative to the output's scale, 1e-5
# leaves margin; a wrong padding split or shortcut moves outputs by O(1).
CNN_RTOL = 1e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ref_params(model, x, seed):
    """Reference-keyed params of ``model`` for input ``x``: the reference
    init's tree and shapes, filled with seeded N(0, 0.5²) draws."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _port_out(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("hidden", [(16, 16), ()])
def test_mlp_extractor_parity(hidden):
    x = _rand(0, (9, 7))
    ref = jx.make_mlp_extractor(rep_dim=8, hidden=hidden)
    params = ref_params(ref, x, 1)
    port = bridge.load_jax_params(tx.make_mlp_extractor(7, 8, hidden), params)
    np.testing.assert_allclose(
        _port_out(port, x), np.asarray(ref.apply(params, x)), atol=DENSE_TOL, rtol=0
    )


@pytest.mark.parametrize("hidden", [(), (12,)])
def test_classifier_parity(hidden):
    x = _rand(2, (5, 24))
    ref = jx.make_classifier(10, hidden=hidden)
    params = ref_params(ref, x, 3)
    port = bridge.load_jax_params(tx.make_classifier(24, 10, hidden), params)
    np.testing.assert_allclose(
        _port_out(port, x), np.asarray(ref.apply(params, x)), atol=DENSE_TOL, rtol=0
    )


@pytest.mark.parametrize(
    "widths,blocks,hw",
    [
        ((8, 16), 1, (8, 8)),  # projection shortcut, even sizes: (0, 1) pads
        ((8, 16), 2, (7, 9)),  # projection shortcut, odd sizes: (1, 1) pads
        ((8, 8), 1, (8, 6)),  # strided identity shortcut h[:, ::2, ::2]
        ((8, 8), 2, (9, 7)),
    ],
)
def test_cnn_extractor_parity(widths, blocks, hw):
    x = _rand(4, (3, *hw, 3))
    ref = jx.make_cnn_extractor(rep_dim=12, widths=widths, blocks_per_stage=blocks)
    params = ref_params(ref, x, 5)
    port = bridge.load_jax_params(tx.make_cnn_extractor(3, 12, widths, blocks), params)
    want = np.asarray(ref.apply(params, x))
    err = np.abs(_port_out(port, x) - want).max()
    assert err <= CNN_RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (7, 3, 2), (9, 3, 1), (16, 1, 2), (5, 3, 3)])
def test_same_pads_match_xla(n, k, s):
    assert list(tx.same_pads(n, k, s)) == list(
        jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    )


def test_bridge_roundtrip_is_exact():
    ref = jx.make_cnn_extractor(rep_dim=6, widths=(8, 16), blocks_per_stage=1)
    params = ref_params(ref, np.zeros((2, 8, 8, 3), np.float32), 0)
    port = bridge.load_jax_params(tx.make_cnn_extractor(3, 6, (8, 16), 1), params)
    back = bridge.to_jax_params(port)
    flat_ref, tree_ref = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bridge_rejects_wrong_layout():
    params = ref_params(
        jx.make_mlp_extractor(rep_dim=4, hidden=(8,)), np.zeros((1, 5), np.float32), 0
    )
    with pytest.raises(ValueError, match="shape"):
        bridge.load_jax_params(tx.make_mlp_extractor(6, 4, (8,)), params)
    with pytest.raises(ValueError, match="keys"):
        bridge.load_jax_params(tx.make_mlp_extractor(5, 4, (8, 8)), params)


def test_seeded_init_is_deterministic():
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return bridge.to_jax_params(tx.make_cnn_extractor(3, 6, (8, 16), 1).init_(g))

    a, b, c = build(0), build(0), build(1)
    np.testing.assert_array_equal(a["stem"], b["stem"])
    assert not np.array_equal(a["stem"], c["stem"])
    np.testing.assert_array_equal(a["s0b0"]["gn1_scale"], np.ones(8, np.float32))
