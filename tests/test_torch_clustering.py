"""Step ③ of the port against ``repro.core.clustering`` and the k-means
kernel's plain version against ``repro.kernels.kmeans.ref``.

The k-means++ draws are the reference's: for restart r the reference splits
its key into R restart keys, takes the first centre from ``randint`` and
each later pick from one uniform inside ``jax.random.choice``; the tests
derive exactly those numbers and hand them to the port. The gradients are
the real step-② gradients of ``hard/overlap-32`` at seed 0, computed by the
reference's own protocol code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import clustering as jclust
from repro.core.protocol import _build_clients
from repro.core.server import VFLServer
from repro.kernels.kmeans import ref as jkref
from repro_torch.core import clustering as tclust
from repro_torch.engine import dispatch
from repro_torch.kernels.kmeans import ops, ref

# Assignments compare exactly except on near-ties: rows whose best and
# second-best squared distances differ by at most NEAR_TIE may flip, since
# the two sides sum the d-long dots in different orders. Rows are unit
# vectors, so distances lie in [0, 4].
NEAR_TIE = 1e-5
# Centres are means of unit rows, renormalised, after 25 Lloyd iterations:
# f32 sums in other orders, a few ulps apart.
CENTER_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _assert_assignments_agree(got, want, x, centers, max_exempt_share):
    """Equal on every row whose best two distances are more than NEAR_TIE
    apart; returns the number of exempt (near-tie) rows."""
    d = np.sort(np.asarray(ref.sq_dists(_t(x), _t(centers))), axis=-1)
    gap = d[..., 1] - d[..., 0] if d.shape[-1] > 1 else np.full(d.shape[:-1], np.inf)
    exempt = gap <= NEAR_TIE
    np.testing.assert_array_equal(np.asarray(got)[~exempt], np.asarray(want)[~exempt])
    assert exempt.mean() <= max_exempt_share
    return int(exempt.sum())


@pytest.mark.parametrize(
    "b,n,d,c",
    [(3, 1000, 77, 37), (8, 2048, 128, 10), (2, 32, 16, 2), (1, 5, 3, 1), (2, 300, 513, 130)],
)
def test_kmeans_op_on_cpu_matches_reference_oracle(b, n, d, c, monkeypatch):
    x, m = _unit(b * n, (b, n, d)), _unit(c + d, (b, c, d))
    calls = []
    plain = ref.kmeans_assign_batched
    monkeypatch.setattr(ref, "kmeans_assign_batched", lambda *a: calls.append(1) or plain(*a))
    before = ops.LAUNCHES
    got = ops.kmeans_assign_batched(_t(x), _t(m))
    assert calls and ops.LAUNCHES == before  # the plain version, no launch
    assert got.dtype == torch.int32 and got.shape == (b, n)
    xs, ms = jnp.asarray(x), jnp.asarray(m)
    want = np.stack([np.asarray(jkref.kmeans_assign(xs[i], ms[i])) for i in range(b)])
    _assert_assignments_agree(got, want, x, m, 1e-3)
    idx, mind = ops.kmeans_assign_min_batched(_t(x), _t(m))
    assert torch.equal(idx, got)
    want_min = np.stack([np.asarray(jkref.kmeans_min_dist(xs[i], ms[i])) for i in range(b)])
    np.testing.assert_allclose(mind.numpy(), want_min, atol=1e-5, rtol=0)
    port_min = torch.stack([ref.kmeans_min_dist(_t(x[i]), _t(m[i])) for i in range(b)])
    assert torch.equal(port_min, mind)  # the port's oracle is the op's CPU route


def test_kmeans_op_takes_bf16_and_broadcast_views():
    x, m = _unit(1, (1, 200, 24)), _unit(2, (3, 9, 24))
    xs = _t(x).expand(3, -1, -1)  # stride-0 batch
    got = ops.kmeans_assign_batched(xs.bfloat16(), _t(m).bfloat16())
    want = ref.kmeans_assign_batched(xs.bfloat16().float(), _t(m).bfloat16().float())
    assert torch.equal(got, want)
    assert torch.equal(ops.kmeans_assign(_t(x[0]), _t(m[0])), ref.kmeans_assign(_t(x[0]), _t(m[0])))


def test_kmeans_op_checks_inputs_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(ref, "kmeans_assign_batched", lambda *a: pytest.fail("plain route taken"))
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no k-means route"):
        ops.kmeans_assign_batched(q, q)
    with pytest.raises(ValueError, match="batch sizes"):
        ops.kmeans_assign_batched(torch.zeros(2, 4, 8), torch.zeros(1, 3, 8))
    with pytest.raises(ValueError, match="width"):
        ops.kmeans_assign_batched(torch.zeros(1, 4, 8), torch.zeros(1, 3, 7))
    with pytest.raises(TypeError):
        ops.kmeans_assign_batched(torch.zeros(1, 4, 8, dtype=torch.int32), torch.zeros(1, 3, 8))


def test_assign_clusters_follows_the_near_tie_rule():
    x, m = _unit(5, (4000, 64)), _unit(6, (50, 64))
    got = tclust.assign_clusters(_t(x), _t(m))
    want = jclust.assign_clusters(jnp.asarray(x), jnp.asarray(m))
    exempt = _assert_assignments_agree(got, want, x, m, 1e-3)
    assert exempt <= 4  # 0.1 % of 4000 random rows


# ------------------------------------------------- the real step-② gradients
@pytest.fixture(scope="module")
def step2():
    """hard/overlap-32, seed 0: the reference's step-② gradients and its
    step-③ k-means keys and pseudo-labels, split as ``_one_shot_seeds``
    splits them."""
    bundle = jscen.build("hard/overlap-32", seed=0)
    split = bundle.split
    key, k_clients, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    clients = _build_clients(k_clients, split, bundle.extractors, bundle.ssl_cfgs)
    reps = [c.extract(x) for c, x in zip(clients, split.aligned)]
    key, kg = jax.random.split(key)
    grads = VFLServer(num_classes=split.num_classes).partial_gradients(kg, reps, split.labels)
    _, kk, _ = jax.random.split(key, 3)
    keys = [jax.random.fold_in(kk, c.index) for c in clients]
    pseudo = [
        jclust.gradient_pseudo_labels(k, g, split.num_classes, 25, restarts=4)
        for k, g in zip(keys, grads)
    ]
    return split, grads, keys, pseudo


def _ref_seeding_draws(key, restarts, n, num_clusters):
    firsts, us = [], []
    for k in jax.random.split(key, restarts):
        k, k0 = jax.random.split(k)
        firsts.append(int(jax.random.randint(k0, (), 0, n)))
        row = []
        for _ in range(1, num_clusters):
            k, kc = jax.random.split(k)
            row.append(float(jax.random.uniform(kc, (), jnp.float32)))
        us.append(row)
    return torch.tensor([firsts]), torch.tensor([us], dtype=torch.float32)


def test_centres_and_restart_match_reference_on_protocol_gradients(step2):
    """Each restart's k-means++ seeds equal the reference's (the same
    inverse-CDF picks), and the lowest-inertia restart's centres and final
    labels match the reference's search."""
    split, grads, keys, pseudo = step2
    c = split.num_classes
    for g, key, want_labels in zip(grads, keys, pseudo):
        first, u = _ref_seeding_draws(key, 4, g.shape[0], c)
        draws = tclust.SeedingDraws(first, u)
        xn_r, centers_r = jclust._normalized_search(key, g, c, 25, 4)
        xn = tclust.normalize_rows(_t(g))
        seeds = tclust.kmeanspp_init(xn[None].expand(4, -1, -1), c, first[0], u[0])
        for r, k_r in enumerate(jax.random.split(key, 4)):
            want = jclust._kmeanspp_init(k_r, xn_r, c)
            np.testing.assert_allclose(seeds[r].numpy(), np.asarray(want), atol=1e-6, rtol=0)
        _, all_centers, inertia = tclust.normalized_search_batched(_t(g)[None], c, 25, 4, draws)
        chosen = int(inertia[0].argmin())
        np.testing.assert_allclose(
            all_centers[0, chosen].numpy(), np.asarray(centers_r), atol=CENTER_TOL, rtol=0
        )
        labels = dispatch.pseudo_labels(_t(g), c, 25, 4, draws=draws)
        exempt = _assert_assignments_agree(
            labels, want_labels, xn.numpy(), all_centers[0, chosen].numpy(), 0.0
        )
        assert exempt == 0


def test_pseudo_labels_are_pure_on_protocol_gradients(step2):
    """The port's batched step ③ (its own draws) recovers the server's
    labels on both parties: purity > 0.5, the reference's bar."""
    split, grads, _, _ = step2
    labels = dispatch.pseudo_labels_batched(
        torch.stack([_t(g) for g in grads]), split.num_classes, 25, 4,
        generator=torch.Generator().manual_seed(0),
    )
    assert labels.shape == (2, 32) and labels.dtype == torch.int64
    y = _t(split.labels)
    for lab in labels:
        assert tclust.cluster_purity(lab, y, split.num_classes) > 0.5
        assert tclust.cluster_purity(lab, y, 2) == pytest.approx(
            jclust.cluster_purity(jnp.asarray(lab.numpy()), jnp.asarray(split.labels), 2)
        )


def test_lloyd_keeps_an_empty_cluster_in_place():
    """Rows near +e₀: the centre at −e₀ wins no row, so it stays where it
    was; the others move to their (renormalised) member means."""
    rng = np.random.default_rng(0)
    x = np.zeros((1, 40, 8), np.float32)
    x[0, :, 0] = 1.0
    x[0, :, 1:] = 0.1 * rng.standard_normal((40, 7))
    x = torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))
    centers = torch.zeros(1, 3, 8)
    centers[0, 0], centers[0, 1] = x[0, 0], x[0, 1]
    centers[0, 2, 0] = -1.0
    out = tclust.lloyd(x, centers.clone(), 1)
    assert torch.equal(out[0, 2], centers[0, 2])
    assert not torch.equal(out[0, :2], centers[0, :2])
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(1, 3))
