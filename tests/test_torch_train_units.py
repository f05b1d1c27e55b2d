"""The port's optimizer, ledger, metrics and data against the reference
(``repro.optim``, ``repro.core.comm`` / ``metrics``, ``repro.data``), on
seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import comm as jcomm
from repro.core import metrics as jmetrics
from repro.data import loader as jloader
from repro.data import vertical as jvert
from repro.optim import transform as jtransform
from repro_torch import optim as topt
from repro_torch.core import comm as tcomm
from repro_torch.core import metrics as tmetrics
from repro_torch.data import loader as tloader
from repro_torch.data import synthetic as tsyn
from repro_torch.data import vertical as tvert

# One clip + momentum step is a few f32 multiply-adds per element.
OPT_TOL = 1e-6


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {
        "b0": (scale * rng.standard_normal(5)).astype(np.float32),
        "w0": (scale * rng.standard_normal((4, 5))).astype(np.float32),
        "w1": (scale * rng.standard_normal((5, 3))).astype(np.float32),
    }


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])  # below and above the clip
def test_clipped_sgd_matches_reference(steps, grad_scale):
    params = _tree(0, 1.0)
    tx = jopt.chain(jopt.clip_by_global_norm(5.0), jopt.sgd(0.05, momentum=0.9))
    state = tx.init(params)
    ref = params
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = topt.ClippedSGD(list(port.values()), lr=0.05, momentum=0.9, max_norm=5.0)
    for s in range(steps):
        grads = _tree(10 + s, grad_scale)
        updates, state = tx.update(grads, state, ref)
        ref = jopt.apply_updates(ref, updates)
        opt.step([torch.from_numpy(grads[k]) for k in port])
    for k in port:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), atol=OPT_TOL, rtol=0)


def test_clip_factor_uses_the_reference_epsilon():
    g = [torch.tensor([3.0, 4.0])]
    norm = float(jtransform.global_norm({"g": jnp.asarray([3.0, 4.0])}))
    assert float(topt.global_norm(g)) == norm == 5.0
    topt.clip_by_global_norm_(g, 1.0)
    want, _ = jopt.clip_by_global_norm(1.0).update({"g": jnp.asarray([3.0, 4.0])}, ())
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(want["g"]))
    small = [torch.tensor([0.3, 0.4])]
    topt.clip_by_global_norm_(small, 1.0)  # under the bound: unchanged
    assert small[0].tolist() == pytest.approx([0.3, 0.4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_nbytes_equal_reference(dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    shapes = [(32, 16), (7,), (2, 3, 5)]
    payload = [torch.zeros(s, dtype=tdt) for s in shapes]
    ref = [jnp.zeros(s, dtype=jdt) for s in shapes]
    assert tcomm.nbytes(payload) == jcomm.nbytes(ref)
    assert tcomm.nbytes({"a": payload[0]}) == jcomm.nbytes({"a": ref[0]})


def test_ledger_rounds_and_comm_times_match_reference():
    ledgers = []
    for mod in (jcomm, tcomm):
        led = mod.CommLedger()
        r = led.next_round()
        led.log_bytes(0, "up", "reps_overlap", 2048, round=r)
        led.log_bytes(1, "up", "reps_overlap", 2048, round=r)
        led.log_bytes(0, "down", "partial_grads", 512)
        ledgers.append(led)
    ref, port = ledgers
    assert [e.__dict__ for e in port.events] == [e.__dict__ for e in ref.events]
    assert port.comm_times() == ref.comm_times() == 2
    assert port.comm_times(1) == ref.comm_times(1) == 1
    assert port.total_bytes() == ref.total_bytes()
    assert port.by_tag() == ref.by_tag()
    assert port.summary() == ref.summary()
    with pytest.raises(ValueError):
        port.log_bytes(0, "sideways", "x", 1)


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    scores = rng.random(200).astype(np.float32)
    scores[:40] = 0.5  # ties take average ranks
    labels = rng.integers(0, 2, 200)
    assert tmetrics.binary_auc(torch.from_numpy(scores), torch.from_numpy(labels)) == pytest.approx(
        jmetrics.binary_auc(scores, labels), abs=1e-12
    )
    assert tmetrics.binary_auc(scores, np.zeros(200)) == 0.5
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    y = rng.integers(0, 4, 50)
    assert tmetrics.accuracy(torch.from_numpy(logits), torch.from_numpy(y)) == pytest.approx(
        jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(y))
    )


def test_epoch_batches_equal_reference():
    for n, bs, seed in ((100, 32, 0), (31, 8, 7), (5, 5, 3)):
        for drop in (True, False):
            got = list(tloader.epoch_batches(n, bs, seed, drop))
            want = list(jloader.epoch_batches(n, bs, seed, drop))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["tabular", "image"])
def test_partition_equals_reference(kind):
    rng = np.random.default_rng(1)
    if kind == "tabular":
        x = rng.standard_normal((203, 9)).astype(np.float32)
        kw = {"feature_sizes": (4, 5)}
    else:
        x = rng.standard_normal((61, 6, 7, 2)).astype(np.float32)
        kw = {}
    y = rng.integers(0, 3, x.shape[0])
    ref = jvert.make_vfl_partition(jnp.asarray(x), jnp.asarray(y), 13, seed=5, **kw)
    port = tvert.make_vfl_partition(torch.from_numpy(x), torch.from_numpy(y), 13, seed=5, **kw)
    conv = tvert.split_from_numpy(ref, device="cpu")
    for got in (port, conv):
        assert got.num_classes == ref.num_classes == 3
        for field in ("aligned", "unaligned", "test_aligned", "unaligned_labels"):
            for a, b in zip(getattr(got, field), getattr(ref, field)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
        np.testing.assert_array_equal(got.test_labels.numpy(), np.asarray(ref.test_labels))
    if kind == "image":
        assert [a.shape[2] for a in port.aligned] == [3, 4]  # W split, remainder last


def test_split_conversion_refuses_padded_overlap():
    """A padded (``overlap_capacity``) split converts with its rows in the
    reference's order and its validity mask, float32: 10 real rows, then 6
    cyclic duplicates under zeros. The port's own partition gives the same."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((100, 4)), jnp.float32)
    y = jnp.asarray(np.arange(100) % 2)
    ref = jvert.make_vfl_partition(x, y, 10, seed=0, overlap_capacity=16)
    got = tvert.split_from_numpy(ref, device="cpu")
    assert got.aligned_mask.dtype == torch.float32
    np.testing.assert_array_equal(got.aligned_mask.numpy(), [1.0] * 10 + [0.0] * 6)
    np.testing.assert_array_equal(got.aligned[0].numpy(), np.asarray(ref.aligned[0]))
    own = tvert.make_vfl_partition(
        torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y)), 10, seed=0,
        overlap_capacity=16,
    )
    assert torch.equal(own.aligned_mask, got.aligned_mask)
    assert torch.equal(own.aligned[1], got.aligned[1])


def test_synthetic_generators_shapes_and_balance():
    x, y = tsyn.make_cluster_tabular(3000, seed=1000, device="cpu")
    assert x.shape == (3000, 40) and x.dtype == torch.float32 and y.shape == (3000,)
    assert set(y.tolist()) == {0, 1}
    assert 0.4 < y.float().mean() < 0.6  # 12 clusters split 6/6, 15 % flips
    x2, _ = tsyn.make_cluster_tabular(3000, seed=1000, device="cpu")
    assert torch.equal(x, x2)
    # nuisance columns (8 in each party's block) carry σ = 2
    assert float(x[:, 12:20].std()) == pytest.approx(2.0, rel=0.1)
    xi, yi = tsyn.make_image_classification(2000, seed=3, device="cpu")
    assert xi.shape == (2000, 32, 32, 3) and xi.dtype == torch.float32
    counts = torch.bincount(yi, minlength=10)
    assert counts.min() > 150 and counts.max() < 250
    assert bool(torch.isfinite(xi).all())
    # classes differ in their mean image; the templates make them separable
    means = torch.stack([xi[yi == c].mean(0) for c in range(10)])
    assert float((means[0] - means[1]).abs().mean()) > 0.1
