"""The port's iterative-baseline units against the reference
(``repro.engine.iterative``, ``repro.core.baselines``): the schedules, the
unclipped SGD, the differentiable Eq. 10 and its gradients, and 10 steps of
each step kind from the reference's own initial parameters, carried across
with ``repro_torch.bridge``, over the reference's schedules.

Data is ``hard/overlap-32``'s split from the reference, carried across
through numpy. The reference's FedCVT step differentiates its jnp Eq. 10
route (no Pallas kernel), as the port's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro import scenarios as jscen
from repro.core import baselines as jbase
from repro.core import estimator as jest
from repro.core.protocol import _build_clients
from repro.core.server import VFLServer as JServer
from repro.engine import iterative as jiter
from repro_torch import bridge
from repro_torch import optim as topt
from repro_torch import scenarios
from repro_torch.core import baselines as tbase
from repro_torch.core import estimator as test_
from repro_torch.data import split_from_numpy
from repro_torch.engine import iterative as titer
from repro_torch.kernels.sdpa_estimator import ops
from repro_torch.models import extractors as tx

# Ten SGD steps of f32 MLPs on 32-row batches, summed in other orders:
# parameters and losses agree to a few 1e-7; 1e-5 is the repo's f32 bar.
STEP_TOL = 1e-5
# Eq. 10 and its gradients on O(1) inputs: a few f32 ulps.
EQ10_TOL = 1e-5
STEPS = 10
SEED0 = 1234  # the schedules' seed in the step tests (any integer)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one intra-op thread runs them faster than a
    spinning pool, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- schedules
SCHEDULE_CASES = [
    (3, 100, 32, 10),  # n not divisible by bs, over several epochs
    (5, 70, 32, 9),  # 2 rows an epoch: 5 epochs
    (0, 50, 32, 0),  # no iterations
    (1, 20, 32, 5),  # n below bs: bs = n
    (7, 3000, 32, 400),  # hard/overlap-32's budget at N = 3000
]


@pytest.mark.parametrize("seed,n,bs,iterations", SCHEDULE_CASES)
def test_iteration_schedule_equals_reference(seed, n, bs, iterations):
    want = np.asarray(jiter.build_iteration_schedule(seed, n, bs, iterations))
    got = titer.build_iteration_schedule(seed, n, bs, iterations)
    assert got.shape == want.shape and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,bs,rounds", SCHEDULE_CASES)
def test_fedbcd_schedule_equals_reference(seed, n, bs, rounds):
    want = np.asarray(jbase._fedbcd_schedule(seed, n, bs, rounds))
    got = tbase.fedbcd_schedule(seed, n, bs, rounds)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "pools,iterations",
    [((1184, 1184), 7), ((50, 0), 5), ((0, 0), 3), ((7, 300, 0, 9), 4), ((40, 40), 0)],
)
def test_unaligned_schedule_equals_reference(pools, iterations):
    want = jiter.build_unaligned_schedule(0, pools, 32, iterations)
    got = titer.build_unaligned_schedule(0, pools, 32, iterations)
    assert len(got) == len(want) == len(pools)
    for g, w, n_u in zip(got, want, pools):
        assert g.shape == w.shape == (iterations, 32 if n_u else 0)
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------ unclipped SGD
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])  # 10: a clip at 5 would bite
def test_unclipped_sgd_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)), "b": rng.standard_normal(5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    tx_ = jopt.sgd(0.05, momentum=0.9)
    state, ref = tx_.init(params), params
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = topt.ClippedSGD(list(port.values()), lr=0.05, momentum=0.9, max_norm=None)
    for s in range(5):
        g = {
            k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()
        }
        upd, state = tx_.update(g, state, ref)
        ref = jopt.apply_updates(ref, upd)
        opt.step([torch.from_numpy(g[k]) for k in port])
    for k in port:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=0)


# ----------------------------------------------------- differentiable Eq. 10
def _eq10_inputs(seed, nu=7, no=5, d=4, db=3):
    rng = np.random.default_rng(seed)
    shapes = ((nu, d), (no, d), (no, db), (nu, db))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("shape", [(7, 5, 4, 3), (32, 32, 16, 16), (0, 5, 4, 3)])
def test_differentiable_eq10_and_its_three_gradients_match_jax(shape):
    hu, ha, hb, w = _eq10_inputs(1, *shape)

    def ref_loss(hu, ha, hb):
        return jnp.sum(jest.sdpa_transform(hu, ha, hb) * w)

    want = jest.sdpa_transform(hu, ha, hb)
    want_g = jax.grad(ref_loss, argnums=(0, 1, 2))(hu, ha, hb)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (hu, ha, hb)]
    got = test_.sdpa_transform_differentiable(*ts)
    got_g = torch.autograd.grad((got * torch.from_numpy(w)).sum(), ts, allow_unused=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=EQ10_TOL, rtol=0)
    for g, wg in zip(got_g, want_g):
        g = torch.zeros_like(ts[0]) if g is None else g  # N_u = 0: no graph to any input
        np.testing.assert_allclose(g.numpy().reshape(np.shape(wg)), np.asarray(wg), atol=EQ10_TOL)


def test_kernel_wrapper_keeps_autograd_on_cpu_tensors():
    """The CUDA route refuses inputs under grad (the kernel has no backward);
    a CPU tensor takes the plain version, whose autograd is intact and equal
    to the differentiable Eq. 10's."""
    hu, ha, hb, w = _eq10_inputs(2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (hu, ha, hb)]
    out = ops.sdpa_estimate(*ts)
    assert out.requires_grad
    got_g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    want = test_.sdpa_transform_differentiable(*ts)
    want_g = torch.autograd.grad((want * torch.from_numpy(w)).sum(), ts)
    torch.testing.assert_close(out, want, atol=EQ10_TOL, rtol=0)
    for g, wg in zip(got_g, want_g):
        torch.testing.assert_close(g, wg, atol=EQ10_TOL, rtol=0)


# ---------------------------------------------------- the steps, 10 of each
@pytest.fixture(scope="module")
def reference_state():
    """hard/overlap-32 at seed 0 and the reference's initial state: clients
    from ``_build_clients``, the server head from ``_init_server``, on the
    key split of ``baselines._seed_sessions_setup``."""
    bundle = jscen.build("hard/overlap-32", seed=0)
    _, kc, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    clients = _build_clients(kc, bundle.split, bundle.extractors, bundle.ssl_cfgs)
    reps0 = [c.extract(x[:2]) for c, x in zip(clients, bundle.split.aligned)]
    server = jbase._init_server(ks, JServer(num_classes=2), reps0)
    return bundle, clients, server


def _port_models(clients, server):
    spec = scenarios.extractor_specs_for(scenarios.HARD_OVERLAP_32)[0]
    exts = [bridge.load_jax_params(spec.build((20,)), c.params.extractor) for c in clients]
    clf = bridge.load_jax_params(tx.make_classifier(32, 2), server.params)
    return exts, clf


def _assert_close(got, want, what):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=STEP_TOL, rtol=STEP_TOL, err_msg=what
    )


def _run_both(state, kind, cfg, unaligned=None, q=None):
    """Ten steps of ``kind`` in both packages from the same parameters over
    the reference's schedules; returns the port's models and the per-step
    mask counts of the port's FedCVT terms (before each step)."""
    bundle, clients, server = state
    split = bundle.split
    if unaligned is not None:
        split = dataclasses.replace(split, unaligned=unaligned)
    hp = cfg.iter_hparams()
    j_ext = [c.extractor for c in clients]
    make = {
        "splitnn": lambda: jiter.make_splitnn_step_fn(j_ext, server.classifier, hp),
        "fedcvt": lambda: jiter.make_fedcvt_step_fn(j_ext, server.classifier, hp),
        "fedbcd": lambda: jiter.make_fedbcd_step_fn(j_ext, server.classifier, hp, q),
    }[kind]
    j_step = jax.jit(make())
    carry = jbase._session_carry(clients, server, cfg)
    n = split.labels.shape[0]
    sched = np.asarray(jiter.build_iteration_schedule(SEED0, n, cfg.batch_size, STEPS))
    u_sched = [np.asarray(u) for u in jiter.build_unaligned_schedule(
        0, [u.shape[0] for u in split.unaligned], cfg.batch_size, STEPS)]

    t_split = split_from_numpy(split, device="cpu")
    exts, clf = _port_models(clients, server)
    t_make = {
        "splitnn": lambda: titer.make_splitnn_step_fn(exts, clf, hp),
        "fedcvt": lambda: titer.make_fedcvt_step_fn(exts, clf, hp),
        "fedbcd": lambda: titer.make_fedbcd_step_fn(exts, clf, hp, q),
    }[kind]
    t_step = t_make()
    masks = []
    for i in range(STEPS):
        xs = tuple(x[sched[i]] for x in split.aligned)
        xs_u = tuple(u[us[i]] for u, us in zip(split.unaligned, u_sched))
        xs_u = xs_u if kind == "fedcvt" else None
        carry, j_loss = j_step(carry, xs, split.labels[sched[i]], xs_u)
        il = torch.from_numpy(sched[i])
        t_xs = [x[il] for x in t_split.aligned]
        t_xs_u = [u[torch.from_numpy(us[i])] for u, us in zip(t_split.unaligned, u_sched)]
        if kind == "fedcvt":
            masks.append(_mask_counts(exts, clf, t_xs, t_xs_u, hp.fedcvt_threshold))
        t_loss = t_step(t_xs, t_split.labels[il], t_xs_u if kind == "fedcvt" else None)
        _assert_close(float(t_loss), float(j_loss), f"{kind} loss at step {i}")
    for k, e in enumerate(exts):
        got, want = bridge.to_jax_params(e), carry[0][k].extractor
        for key in want:
            _assert_close(got[key], want[key], f"{kind} party {k} {key}")
        # the client heads ride in the reference's carry with zero gradient
        for key, v in carry[0][k].head.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(clients[k].params.head[key]))
    got = bridge.to_jax_params(clf)
    for key in carry[1]:
        _assert_close(got[key], carry[1][key], f"{kind} classifier {key}")
    return exts, clf, masks


@torch.no_grad()
def _mask_counts(exts, clf, xs, xs_u, threshold):
    """Per party, how many unaligned rows clear the confidence threshold."""
    reps_o = [e(x) for e, x in zip(exts, xs)]
    counts = []
    for k, (e, x_u) in enumerate(zip(exts, xs_u)):
        h_u = e(x_u)
        parts = [h_u if j == k else test_.sdpa_transform_differentiable(h_u, reps_o[k], o)
                 for j, o in enumerate(reps_o)]
        conf = torch.softmax(clf(torch.cat(parts, -1)), -1).amax(-1)
        counts.append(int((conf > threshold).sum()))
    return counts


def test_splitnn_step_matches_reference(reference_state):
    _run_both(reference_state, "splitnn", jbase.IterativeConfig())


def test_fedbcd_step_matches_reference(reference_state):
    _run_both(reference_state, "fedbcd", jbase.IterativeConfig(fedbcd_q=5), q=5)


def test_fedcvt_step_matches_reference_with_a_partial_mask(reference_state):
    """At t = 0.75 some but not all of an unaligned batch pass in some step,
    so the masked term is exercised on both sides."""
    _, _, masks = _run_both(reference_state, "fedcvt", jbase.IterativeConfig(fedcvt_threshold=0.75))
    assert any(0 < m < 32 for step in masks for m in step), masks


def test_fedcvt_step_matches_reference_with_one_pool_empty(reference_state):
    bundle = reference_state[0]
    pools = [bundle.split.unaligned[0], bundle.split.unaligned[1][:0]]
    _, _, masks = _run_both(
        reference_state, "fedcvt", jbase.IterativeConfig(fedcvt_threshold=0.75), unaligned=pools
    )
    assert all(step[1] == 0 for step in masks)


def test_fedcvt_with_every_pool_empty_is_splitnn_exactly(reference_state):
    """An empty pool's unaligned term is exactly 0: with both pools empty a
    FedCVT step equals a SplitNN step bit for bit."""
    _, clients, server = reference_state
    split = split_from_numpy(reference_state[0].split, device="cpu")
    hp = jbase.IterativeConfig(fedcvt_threshold=0.0).iter_hparams()
    runs = []
    for make in (titer.make_splitnn_step_fn, titer.make_fedcvt_step_fn):
        exts, clf = _port_models(clients, server)
        step = make(exts, clf, hp)
        sched = titer.build_iteration_schedule(SEED0, 32, 32, STEPS)
        empty = [u[:0] for u in split.unaligned]
        losses = [
            step([x[s] for x in split.aligned], split.labels[s], empty)
            for s in torch.from_numpy(sched)
        ]
        runs.append((losses, [p.clone() for m in (*exts, clf) for p in m.parameters()]))
    (l_a, p_a), (l_b, p_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(l_a, l_b))
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
