"""The port's server (steps ② and ⑥) against ``repro.core.server``: the
partial gradients at the same classifier, and a classifier fit from the
same initial parameters over the same numpy-seeded schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import server as jserver
from repro.models import extractors as jx
from repro_torch import bridge
from repro_torch.core import server as tserver
from repro_torch.models import extractors as tx

# ∇ of a mean cross-entropy through one linear layer: a few f32 ulps.
GRAD_TOL = 1e-6
# 40 clipped momentum steps compound rounding differences.
FIT_TOL = 1e-5


def _reps(seed, n, dims):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for d in dims]


@pytest.mark.parametrize("num_classes,dims", [(2, (16, 16)), (10, (8, 5, 3))])
def test_partial_gradients_match_reference(num_classes, dims):
    reps = _reps(0, 32, dims)
    labels = np.random.default_rng(1).integers(0, num_classes, 32)
    ref = jserver.VFLServer(num_classes=num_classes)
    key = jax.random.PRNGKey(3)
    want = ref.partial_gradients(key, [jnp.asarray(r) for r in reps], jnp.asarray(labels))
    port = tserver.VFLServer(num_classes=num_classes)
    port.classifier = bridge.load_jax_params(tx.make_classifier(sum(dims), num_classes), ref.params)
    got = port.partial_gradients([torch.from_numpy(r) for r in reps], torch.from_numpy(labels))
    assert len(got) == len(dims)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)


def test_partial_gradients_initialise_the_classifier_lazily():
    port = tserver.VFLServer(num_classes=3)
    reps = [torch.randn(6, 4), torch.randn(6, 2)]
    with pytest.raises(ValueError, match="generator"):
        port.partial_gradients(reps, torch.zeros(6, dtype=torch.long))
    gen = torch.Generator().manual_seed(0)
    grads = port.partial_gradients(reps, torch.zeros(6, dtype=torch.long), gen)
    assert port.classifier.layers[0].in_features == 6
    assert [g.shape for g in grads] == [(6, 4), (6, 2)]


@pytest.mark.parametrize("n,epochs,bs", [(32, 40, 32), (70, 3, 16), (5, 2, 32)])
def test_fit_schedule_equals_reference(n, epochs, bs):
    key = jax.random.PRNGKey(n)
    want = jserver._fit_schedule(key, n, epochs, bs)
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = tserver.fit_schedule(seed0, n, epochs, bs)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tserver.fit_schedule(seed0, n, 0, bs) is None


def test_classifier_fit_matches_reference():
    h = np.concatenate(_reps(4, 64, (16, 16)), axis=1)
    y = np.random.default_rng(5).integers(0, 2, 64)
    clf = jx.make_classifier(2)
    params = jax.tree_util.tree_map(np.array, clf.init(jax.random.PRNGKey(6), jnp.asarray(h)))
    key = jax.random.PRNGKey(7)
    # the reference's fit donates its parameter buffers: hand it copies
    start = jax.tree_util.tree_map(jnp.array, params)
    want = jserver._fit(key, clf, start, jnp.asarray(h), jnp.asarray(y), 40, 32, 0.01)
    port = bridge.load_jax_params(tx.make_classifier(32, 2), params)
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    schedule = tserver.fit_schedule(seed0, 64, 40, 32)
    tserver.fit(port, torch.from_numpy(h), torch.from_numpy(y), schedule, 0.01)
    got = bridge.to_jax_params(port)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=FIT_TOL, rtol=0)
    moved = max(float(np.abs(np.asarray(want[k]) - np.asarray(params[k])).max()) for k in want)
    assert moved > 100 * FIT_TOL


def test_train_classifier_refits_a_fresh_head():
    srv = tserver.VFLServer(num_classes=2)
    gen = torch.Generator().manual_seed(0)
    reps = [torch.randn(40, 3), torch.randn(40, 3)]
    y = (reps[0][:, 0] > 0).long()
    srv.train_classifier(reps, y, epochs=30, batch_size=8, learning_rate=0.1, generator=gen)
    first = srv.classifier
    assert float((srv.predict_logits(reps).argmax(-1) == y).float().mean()) > 0.8
    srv.train_classifier(reps, y, epochs=0, generator=gen)
    assert srv.classifier is not first  # a fresh head, unfitted with 0 epochs
