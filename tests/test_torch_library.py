"""The port's small library functions against the reference's.

``align_pseudo_to_true`` (the greedy confusion-matrix matching, with empty
clusters), ``batch_iterator`` (``epoch_batches``' numpy permutation, epoch
by epoch), ``numpy_train_test_split`` (``RandomState(seed)``) and the
k-means oracle's ``kmeans_min_dist``. Integers compare equal, floats within
1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jx_data
from repro.core import clustering as jx_clustering
from repro.data import synthetic as jx_synthetic
from repro.kernels.kmeans import ref as jx_kref
from repro_torch import data
from repro_torch.core import clustering
from repro_torch.data import loader, synthetic
from repro_torch.kernels.kmeans import ref as kref


@pytest.mark.parametrize(
    "n, classes, empty, seed",
    [(200, 2, (), 0), (300, 4, (), 1), (300, 5, (2,), 2), (120, 6, (0, 5), 3), (7, 4, (1, 2, 3), 4)],
)
def test_align_pseudo_to_true_matches_the_reference(n, classes, empty, seed):
    """Pseudo-labels that are a noisy relabelling of the true ones; the
    clusters in ``empty`` hold no row."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, classes, n).astype(np.int32)
    relabel = rng.permutation(classes)
    pseudo = np.where(rng.random(n) < 0.8, relabel[true], rng.integers(0, classes, n))
    live = np.array([c for c in range(classes) if c not in empty])
    pseudo = np.where(np.isin(pseudo, empty), live[pseudo % len(live)], pseudo).astype(np.int32)
    assert not np.isin(pseudo, empty).any()
    want = jx_clustering.align_pseudo_to_true(jnp.asarray(pseudo), jnp.asarray(true), classes)
    got = clustering.align_pseudo_to_true(torch.from_numpy(pseudo), torch.from_numpy(true), classes)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_align_pseudo_to_true_recovers_a_permutation():
    true = torch.arange(12) % 3
    pseudo = torch.tensor([2, 0, 1])[true]
    assert torch.equal(clustering.align_pseudo_to_true(pseudo, true, 3), true)


@pytest.mark.parametrize(
    "n, batch, epochs, seed, drop", [(37, 8, 3, 0, True), (37, 8, 2, 5, False), (64, 16, 1, 9, True)]
)
def test_batch_iterator_matches_the_reference(n, batch, epochs, seed, drop):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    want = list(jx_data.batch_iterator([jnp.asarray(x), jnp.asarray(y)], batch, epochs, seed, drop))
    got = list(data.batch_iterator([torch.from_numpy(x), torch.from_numpy(y)], batch, epochs, seed, drop))
    assert len(got) == len(want) == epochs * (n // batch if drop else -(-n // batch))
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    # epoch e is epoch_batches with seed + e, bit for bit
    first = next(loader.epoch_batches(n, batch, seed + epochs - 1, drop))
    last_epoch = got[(epochs - 1) * (len(got) // epochs)]
    np.testing.assert_array_equal(last_epoch[1].numpy(), y[first])


@pytest.mark.parametrize("n, frac, seed", [(100, 0.2, 0), (57, 0.3, 4), (10, 0.0, 1)])
def test_numpy_train_test_split_matches_the_reference(n, frac, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    (wxt, wyt), (wxe, wye) = jx_synthetic.numpy_train_test_split(x, y, frac, seed)
    (gxt, gyt), (gxe, gye) = synthetic.numpy_train_test_split(torch.from_numpy(x), y, frac, seed)
    for got, want in ((gxt, wxt), (gyt, wyt), (gxe, wxe), (gye, wye)):
        assert torch.is_tensor(got) and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gxe.shape[0] == int(n * frac) and gxt.shape[0] + gxe.shape[0] == n


@pytest.mark.parametrize("n, c, d", [(50, 7, 16), (1, 1, 3), (200, 32, 77)])
def test_kmeans_min_dist_matches_the_reference(n, c, d):
    rng = np.random.default_rng(n + c + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    m = rng.standard_normal((c, d)).astype(np.float32)
    want = jx_kref.kmeans_min_dist(jnp.asarray(x), jnp.asarray(m))
    got = kref.kmeans_min_dist(torch.from_numpy(x), torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * max(1.0, d), rtol=1e-5)
    idx, mind = kref.kmeans_assign_min_batched(torch.from_numpy(x)[None], torch.from_numpy(m)[None])
    assert torch.equal(mind[0], got)
