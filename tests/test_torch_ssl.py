"""The port's augmentations and Eq. (4) loss (value and grads) against
``repro.core.augment`` / ``repro.core.ssl``.

PyTorch cannot replay JAX's random streams, so every test derives the
reference's own draws (flips, shifts, cutout centres, jitter, noise, masks)
from the reference's keys, exactly as the reference splits them, and hands
them to the port. Parameters are seeded numpy draws carried across with
``repro_torch.bridge``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import augment as jaug
from repro.core import ssl as jssl
from repro.models import extractors as jx
from repro_torch import bridge
from repro_torch.core import augment as taug
from repro_torch.core import ssl as tssl
from repro_torch.models import extractors as tx

# Masks, flips, shifts and cutout centres are integers or booleans: exact.
# Jitter and noise are one or two f32 multiply-adds per element: 1e-6.
AUG_TOL = 1e-6
# Loss and grads relative to the largest |value| in the tree. The MLP is a
# handful of f32 dots (a few ulps apart); the CNN's GroupNorms rescale the
# two frameworks' different summation orders, so it gets 1e-4.
MLP_RTOL = 1e-5
CNN_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------- the reference's draws, from keys
def ref_image_weak(key, n, max_shift):
    k1, k2 = jax.random.split(key)
    flip = jax.random.bernoulli(k1, 0.5, (n,))
    kx, ky = jax.random.split(k2)
    dx = jax.random.randint(kx, (n,), -max_shift, max_shift + 1)
    dy = jax.random.randint(ky, (n,), -max_shift, max_shift + 1)
    return taug.ImageWeakDraws(flip=_t(flip), dy=_t(dy).long(), dx=_t(dx).long())


def ref_image_strong(key, shape, max_shift):
    n, h, w, c = shape
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    weak = ref_image_weak(k1, n, max_shift)
    ky, kx = jax.random.split(k2)
    cy = jax.random.randint(ky, (n,), 0, h)
    cx = jax.random.randint(kx, (n,), 0, w)
    gain = jax.random.uniform(k3, (n, 1, 1, c), minval=-1, maxval=1)
    bias = jax.random.uniform(k4, (n, 1, 1, c), minval=-1, maxval=1)
    noise = jax.random.normal(k5, shape)
    return taug.ImageStrongDraws(weak, _t(cy).long(), _t(cx).long(), _t(gain), _t(bias), _t(noise))


def ref_ssl_draws(key, cfg, labeled_shape, unlabeled_shape):
    """The draws ``repro.core.ssl.ssl_loss`` makes from ``key``."""
    k_l, k_u = jax.random.split(key)
    if cfg.modality == "image":
        kw, ks = jax.random.split(k_u)
        return tssl.SSLDraws(
            ref_image_weak(k_l, labeled_shape[0], cfg.max_shift),
            (
                ref_image_weak(kw, unlabeled_shape[0], cfg.max_shift),
                ref_image_strong(ks, unlabeled_shape, cfg.max_shift),
            ),
        )
    keep_l = jax.random.bernoulli(k_l, 1.0 - cfg.mask_ratio, labeled_shape)
    km, kn = jax.random.split(k_u)
    keep_u = jax.random.bernoulli(km, 1.0 - cfg.mask_ratio, unlabeled_shape)
    noise = jax.random.normal(kn, unlabeled_shape)
    return tssl.SSLDraws(_t(keep_l), taug.TabPairDraws(_t(keep_u), _t(noise)))


# ------------------------------------------------------------ augmentations
def test_tab_pair_and_weak_view_match_reference():
    key = jax.random.PRNGKey(3)
    x, fm = _rand(0, (17, 9)), _rand(1, (9,))
    weak_r, strong_r = jaug.tab_augment_pair(key, jnp.asarray(x), jnp.asarray(fm), 0.2, 0.1)
    km, kn = jax.random.split(key)
    d = taug.TabPairDraws(
        _t(jax.random.bernoulli(km, 0.8, x.shape)), _t(jax.random.normal(kn, x.shape))
    )
    weak, strong = taug.tab_augment_pair(_t(x), _t(fm), d, 0.1)
    np.testing.assert_array_equal(weak.numpy(), np.asarray(weak_r))
    np.testing.assert_allclose(strong.numpy(), np.asarray(strong_r), atol=AUG_TOL, rtol=0)
    # the weak and strong views share one mask: the masked cells are x̄ in both
    masked = ~d.keep.numpy()
    assert masked.any()
    np.testing.assert_array_equal(weak.numpy()[masked], np.broadcast_to(fm, x.shape)[masked])
    keep = jax.random.bernoulli(key, 0.8, x.shape)
    np.testing.assert_array_equal(
        taug.weak_augment_tab(_t(x), _t(fm), _t(keep)).numpy(),
        np.asarray(jaug.weak_augment_tab(key, jnp.asarray(x), jnp.asarray(fm), 0.2)),
    )


@pytest.mark.parametrize("shape", [(6, 16, 16, 3), (5, 12, 9, 2)])
def test_image_views_match_reference(shape):
    x = _rand(2, shape)
    key = jax.random.PRNGKey(7)
    kw, ks = jax.random.split(key)
    want_w = jaug.weak_augment_image(kw, jnp.asarray(x), 4)
    got_w = taug.weak_augment_image(_t(x), ref_image_weak(kw, shape[0], 4))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    want_s = jaug.strong_augment_image(ks, jnp.asarray(x), 4, 8)
    got_s = taug.strong_augment_image(_t(x), ref_image_strong(ks, shape, 4), 8)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=AUG_TOL, rtol=0)


def test_translate_and_cutout_edges():
    """Every shift sign, including the largest, and cutout at the borders."""
    x = _rand(3, (5, 8, 8, 1))
    dy = np.array([-4, -1, 0, 2, 4])
    dx = np.array([4, 0, -3, -4, 1])
    got = taug.rand_translate(_t(x), _t(dy), _t(dx)).numpy()
    for i in range(5):
        img = np.roll(x[i], (dy[i], dx[i]), axis=(0, 1))
        rows, cols = np.arange(8), np.arange(8)
        rok = rows >= dy[i] if dy[i] >= 0 else rows < 8 + dy[i]
        cok = cols >= dx[i] if dx[i] >= 0 else cols < 8 + dx[i]
        np.testing.assert_array_equal(got[i], img * (rok[:, None] & cok[None, :])[..., None])
    cy, cx = np.array([0, 7, 3, 0, 5]), np.array([0, 7, 3, 7, 0])
    got = taug.cutout(_t(x), _t(cy), _t(cx), 4).numpy()
    rows = np.arange(8)[:, None]
    cols = np.arange(8)[None, :]
    for i in range(5):
        keep = (np.abs(rows - cy[i]) > 2) | (np.abs(cols - cx[i]) > 2)
        np.testing.assert_array_equal(got[i], x[i] * keep[..., None])


# ---------------------------------------------------------- Eq. (4) + grads
def _ref_params(model, sample, seed, scale=0.5):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(sample))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _grad_tree(module):
    g = copy.deepcopy(module)
    for p, q in zip(g.parameters(), module.parameters()):
        p.data = q.grad.detach().clone()
    return bridge.to_jax_params(g)


def _assert_tree_close(got, want, rtol):
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    scale = max(1.0, max(float(np.abs(np.asarray(w)).max()) for w in want_l))
    worst = max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got_l, want_l))
    assert worst <= rtol * scale, (worst, scale)


def _models(kind, feature_shape, num_classes):
    if kind == "mlp":
        ref_e = jx.make_mlp_extractor(rep_dim=6, hidden=(12,))
        port_e = tx.make_mlp_extractor(feature_shape[-1], 6, (12,))
        rep = 6
    else:
        ref_e = jx.make_cnn_extractor(rep_dim=8, widths=(8, 16), blocks_per_stage=1)
        port_e = tx.make_cnn_extractor(feature_shape[-1], 8, (8, 16), 1)
        rep = 8
    return ref_e, port_e, jx.make_classifier(num_classes), tx.make_classifier(rep, num_classes)


CASES = {
    # (modality, model, labeled rows, unlabeled rows, masked); the
    # confidence threshold τ sits inside each case's spread of max q, so
    # the FixMatch mask keeps some rows and drops others
    "tab-mlp": ("tabular", "mlp", 8, 16, False),
    "tab-mlp-masked": ("tabular", "mlp", 8, 16, True),
    "tab-mlp-empty-pool": ("tabular", "mlp", 8, 0, False),
    "image-cnn": ("image", "cnn", 4, 6, False),
    "image-cnn-masked": ("image", "cnn", 4, 6, True),
}
TAU = {"tabular": 0.55, "image": 0.62}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssl_loss_and_grads_match_reference(case):
    modality, kind, n_l, n_u, masked = CASES[case]
    fshape = (7,) if modality == "tabular" else (16, 16, 3)
    cfg = jssl.SSLConfig(modality=modality, confidence_threshold=TAU[modality])
    tcfg = tssl.SSLConfig(modality=modality, confidence_threshold=TAU[modality])
    x_l, x_u = _rand(10, (n_l, *fshape)), _rand(11, (n_u, *fshape))
    y_l = np.random.default_rng(12).integers(0, 3, n_l)
    fm = _rand(13, fshape) if modality == "tabular" else None
    m_l = np.array([1, 0, 1, 1, 0, 1, 1, 1][:n_l], np.float32) if masked else None
    m_u = (np.arange(n_u) % 3 != 1).astype(np.float32) if masked else None
    ref_e, port_e, ref_h, port_h = _models(kind, fshape, 3)
    pe = _ref_params(ref_e, x_l, 20)
    ph = _ref_params(ref_h, np.zeros((1, ref_e.rep_dim), np.float32), 21)
    bridge.load_jax_params(port_e, pe)
    bridge.load_jax_params(port_h, ph)
    key = jax.random.PRNGKey(5)

    def ref_loss(params):
        return jssl.ssl_loss(
            lambda p, x: ref_h.apply(p[1], ref_e.apply(p[0], x)),
            params,
            key,
            jnp.asarray(x_l),
            jnp.asarray(y_l),
            jnp.asarray(x_u),
            cfg,
            None if fm is None else jnp.asarray(fm),
            labeled_mask=None if m_l is None else jnp.asarray(m_l),
            unlabeled_mask=None if m_u is None else jnp.asarray(m_u),
        )

    (loss_r, metrics_r), grads_r = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))((pe, ph))
    draws = ref_ssl_draws(key, cfg, x_l.shape, x_u.shape)
    loss, metrics = tssl.ssl_loss(
        lambda x: port_h(port_e(x)),
        _t(x_l),
        _t(y_l),
        _t(x_u),
        tcfg,
        draws,
        None if fm is None else _t(fm),
        None if m_l is None else _t(m_l),
        None if m_u is None else _t(m_u),
    )
    loss.backward()
    rtol = MLP_RTOL if kind == "mlp" else CNN_RTOL
    for name in ("loss", "l_s", "l_u", "pseudo_mask_rate"):
        want = float(metrics_r[name])
        assert abs(float(metrics[name]) - want) <= rtol * max(1.0, abs(want)), name
    if n_u == 0:
        assert float(metrics["pseudo_mask_rate"]) == 0.0 and float(metrics["l_u"]) == 0.0
    else:
        assert 0.0 < float(metrics_r["pseudo_mask_rate"]) < 1.0  # both terms live
    _assert_tree_close(_grad_tree(port_e), grads_r[0], rtol)
    _assert_tree_close(_grad_tree(port_h), grads_r[1], rtol)
