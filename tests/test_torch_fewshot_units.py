"""The port's few-shot (Alg. 2) modules against the reference: the Eq. 8-9
gate, the ②' aux classifier fits, step ③' for one party, the ⑤' labels and
masks, and a masked ⑤' SSL session.

Inputs are seeded numpy draws; parameters are carried across with
``repro_torch.bridge``. Where the reference reaches the Pallas
``sdpa_estimator`` (③' with ``use_kernels=True``) it runs in interpret mode,
as the reference's own tests run it on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import estimator as jest
from repro.core import protocol as jproto
from repro.core import server as jserver
from repro.core import ssl as jssl
from repro.engine import batched as jbatched
from repro.engine import local_ssl as jlocal
from repro.models import extractors as jx
from repro_torch import bridge
from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core import client as tclient
from repro_torch.core import estimator as test_
from repro_torch.core import protocol as tproto
from repro_torch.core import server as tserver
from repro_torch.core import ssl as tssl
from repro_torch.engine import dispatch
from repro_torch.engine import local_ssl as tlocal
from repro_torch.models import extractors as tx

from test_torch_ssl import _assert_tree_close, _ref_params, _t, ref_ssl_draws

# p̂ is a softmax maximum times a 0/1 gate: a few f32 ulps apart.
PROB_TOL = 1e-6
# Gate decisions compare exactly except where a confidence lies this close
# to the threshold (the two softmaxes round differently).
NEAR_T = 1e-5
# 40 clipped momentum steps of a linear head (as test_torch_server.py).
FIT_TOL = 1e-5
# ③': Eq. 10 estimates (f32 sums in other orders) feed the joint head.
EST_TOL = 1e-5
# A 10-step masked session, relative to the parameters' scale.
SESSION_RTOL = 1e-5


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _dense_params(seed, d, c, scale):
    return {"w0": _rand(seed, (d, c), scale), "b0": _rand(seed + 1, (c,), scale)}


def _near_threshold(logits, t):
    p = torch.softmax(torch.as_tensor(logits).double(), -1).amax(-1)
    return (p - t).abs() <= NEAR_T


# ------------------------------------------------------------ Eq. 8-9 gate
@pytest.mark.parametrize("c,t", [(2, 0.9), (2, 0.6), (10, 0.5), (10, 0.3)])
def test_infer_prob_matches_reference(c, t):
    n = 400
    local, joint = _rand(c, (n, c), 3.0), _rand(c + 100, (n, c), 3.0)
    # ties: equal logits, and rows where both heads' top two classes tie
    local[:5], joint[:5] = 0.0, 0.0
    local[5:10, :2], joint[5:10, :2] = 4.0, 4.0
    want = np.asarray(
        jest.infer_prob(lambda h: h, lambda f: f, jnp.asarray(local), jnp.asarray(joint), t)
    )
    got = test_.infer_prob(lambda h: h, lambda f: f, _t(local), _t(joint), t)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)
    exempt = (_near_threshold(local, t) | _near_threshold(joint, t)).numpy()
    assert ((got.numpy() > 0) == (want > 0))[~exempt].all()
    assert 0 < (want > 0).sum() < n  # the draw gates some rows and not others
    if c == 2 and t < 0.5 + 1e-3:
        assert (got[5:10] > 0).all()  # ties to class 0 on both sides agree


# --------------------------------------------------- ②' aux classifier fits
@pytest.mark.parametrize("dims,c", [((16, 8), 2), ((8, 5, 3), 10)])
def test_aux_fits_match_reference(dims, c):
    """②' from the same init params and seed0 per party as the reference's
    fit: the port's draws (per party the head's init, then the schedule
    seed, from the CPU generator) replayed into the reference's fit
    session (``_fit_session`` over ``_fit_schedule``'s batches, which
    equal ``fit_schedule``'s for equal seed0: ``test_torch_server.py``)."""
    n, epochs, lr = 64, 40, 0.01
    reps = [_rand(10 + k, (n, d)) for k, d in enumerate(dims)]
    y = np.random.default_rng(3).integers(0, c, n)
    port = tserver.VFLServer(num_classes=c)
    port.fit_aux_classifiers(
        [_t(r) for r in reps], _t(y), epochs, 32, lr, generator=torch.Generator().manual_seed(7)
    )
    assert len(port.aux_classifiers) == len(dims)
    replay = torch.Generator().manual_seed(7)
    for k, (r, got_m) in enumerate(zip(reps, port.aux_classifiers)):
        start = bridge.to_jax_params(tx.make_classifier(r.shape[1], c).init_(replay))
        schedule = tserver.fit_schedule(tlocal.seed_from(replay), n, epochs, 32)
        session = jax.jit(jserver._fit_session(jx.make_classifier(c), lr))
        want = session(start, jnp.asarray(r), jnp.asarray(y), jnp.asarray(schedule, jnp.int32))
        got = bridge.to_jax_params(got_m)
        for name in want:
            np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=FIT_TOL, rtol=0)
        moved = max(float(np.abs(np.asarray(want[w]) - start[w]).max()) for w in want)
        assert moved > 100 * FIT_TOL
        np.testing.assert_allclose(
            port.aux_logits_fn(k)(_t(r)).detach().numpy(),
            np.asarray(jx.make_classifier(c).apply(want, jnp.asarray(r))),
            atol=10 * FIT_TOL,
            rtol=0,
        )


# ------------------------------------------------------- ③' for one party
def _servers(dims, c, seed):
    """A reference server and its port copy with the same (seeded) joint and
    aux heads, scaled so that a good share of rows clears t = 0.9."""
    ref = jserver.VFLServer(num_classes=c)
    ref.classifier = jx.make_classifier(c)
    ref.params = _dense_params(seed, sum(dims), c, 1.5)
    ref.aux_classifiers = [jx.make_classifier(c) for _ in dims]
    ref.aux_params = [_dense_params(seed + 10 + k, d, c, 1.5) for k, d in enumerate(dims)]
    port = tserver.VFLServer(num_classes=c)
    port.classifier = bridge.load_jax_params(tx.make_classifier(sum(dims), c), ref.params)
    port.aux_classifiers = [
        bridge.load_jax_params(tx.make_classifier(d, c), p) for d, p in zip(dims, ref.aux_params)
    ]
    return ref, port


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dims,k", [((16, 16), 0), ((16, 16), 1), ((16, 8, 8), 2)])
def test_step3p_matches_reference(dims, k, use_kernels):
    n_u, n_o, c, t = 150, 32, 2, 0.9
    ref, port = _servers(dims, c, seed=len(dims) + k)
    h_o = [_rand(20 + j, (n_o, d), 2.0) for j, d in enumerate(dims)]
    h_u = _rand(30 + k, (n_u, dims[k]), 2.0)
    want = np.asarray(
        jbatched.fewshot_probs_seeds(
            [ref],
            k,
            jnp.asarray(h_u)[None],
            [jnp.asarray(h)[None] for h in h_o],
            t,
            use_kernels=use_kernels,
        )
    )[0]
    got = dispatch.fewshot_probs(port, k, _t(h_u), [_t(h) for h in h_o], t)
    assert got.dtype == torch.float32 and got.shape == (n_u,)
    np.testing.assert_allclose(got.numpy(), want, atol=EST_TOL, rtol=0)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert 0 < (want > 0).sum() < n_u


# ------------------------------------------------ ⑤' labels, masks, session
def _clients(seed, n_feat=20, rep=16, c=2):
    """A reference client and its port copy with the same seeded parameters."""
    ext = jx.make_mlp_extractor(rep, (64,))
    x_mean = _rand(seed, (4, n_feat))
    cfg = dict(modality="tabular", confidence_threshold=0.6)
    ref = jclient.make_client(
        jax.random.PRNGKey(seed),
        0,
        ext,
        c,
        sample_input=jnp.asarray(x_mean),
        ssl_cfg=jssl.SSLConfig(**cfg),
        local_data_for_mean=jnp.asarray(x_mean),
    )
    params = jclient.ClientParams(
        _ref_params(ext, np.zeros((1, n_feat), np.float32), seed + 1),
        _ref_params(jx.make_classifier(c), np.zeros((1, rep), np.float32), seed + 2),
    )
    ref = dataclasses.replace(ref, params=params)
    port = tclient.make_client(
        0,
        ExtractorSpec("mlp", rep, hidden=(64,)),
        (n_feat,),
        c,
        tssl.SSLConfig(**cfg),
        torch.Generator().manual_seed(seed),
        torch.device("cpu"),
        local_data_for_mean=_t(x_mean),
    )
    bridge.load_jax_params(port.extractor, params.extractor)
    bridge.load_jax_params(port.head, params.head)
    return ref, port


@pytest.mark.parametrize("relabel", [False, True])
def test_phase5_labels_match_reference(relabel):
    ref, port = _clients(1)
    x_o, x_u = _rand(2, (32, 20)), _rand(3, (128, 20))
    pseudo = np.random.default_rng(4).integers(0, 2, 32)
    x_o_r, x_u_r, pseudo_r = jnp.asarray(x_o), jnp.asarray(x_u), jnp.asarray(pseudo)
    want = np.asarray(jproto.fewshot_phase5_labels(ref, x_o_r, x_u_r, pseudo_r, relabel))
    got = tproto.fewshot_phase5_labels(port, _t(x_o), _t(x_u), _t(pseudo), relabel)
    np.testing.assert_array_equal(got.numpy(), want)
    # the overlap rows keep Ŷ_o^k; relabelled, they take the head's (other) predictions
    assert (got[:32].numpy() == pseudo).all() != relabel


POOLS = {
    "partly gated": lambda p: np.where(p > 0.5, p, 0.0),
    "fully gated": lambda p: 0.5 + 0.5 * p,
    "not gated": lambda p: 0.0 * p,
}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_phase5_task_and_masked_session_match_reference(pool):
    """The ⑤' task (rows, labels, both masks) equals the reference's
    construction (``_few_shot_seeds``, the ⑤' loop), and a 10-step masked
    session, given the reference's seed0 and per-step draws, ends at the
    reference's parameters."""
    n_o, n_u, epochs = 32, 128, 2
    ref, port = _clients(5)
    x_o, x_u = _rand(6, (n_o, 20)), _rand(7, (n_u, 20))
    pseudo = np.random.default_rng(8).integers(0, 2, n_o)
    probs = POOLS[pool](np.random.default_rng(9).uniform(size=n_u)).astype(np.float32)

    # the reference's ⑤' task, as _few_shot_seeds builds it (no faults, no aligned_mask)
    take_r = (jnp.asarray(probs) > 0).astype(jnp.float32)
    x_lab = jnp.concatenate([jnp.asarray(x_o), jnp.asarray(x_u)], axis=0)
    y_lab = jproto.fewshot_phase5_labels(
        ref, jnp.asarray(x_o), jnp.asarray(x_u), jnp.asarray(pseudo)
    )
    lab_mask = jnp.concatenate([jnp.ones(n_o, jnp.float32), take_r])
    task_r = jclient.ssl_task_for(
        ref, x_lab, y_lab, jnp.asarray(x_u), labeled_mask=lab_mask, unlabeled_mask=1.0 - take_r
    )

    cfg = tproto.ProtocolConfig()
    task, take = tproto.fewshot_task(port, _t(x_o), _t(x_u), _t(probs), _t(pseudo), cfg)
    np.testing.assert_array_equal(take.numpy(), np.asarray(take_r))
    np.testing.assert_array_equal(task.x_labeled.numpy(), np.asarray(x_lab))
    np.testing.assert_array_equal(task.y_pseudo.numpy(), np.asarray(y_lab))
    np.testing.assert_array_equal(task.labeled_mask.numpy(), np.asarray(lab_mask))
    np.testing.assert_array_equal(task.unlabeled_mask.numpy(), np.asarray(task_r.unlabeled_mask))
    np.testing.assert_array_equal(task.x_unlabeled.numpy(), x_u)
    assert task.labeled_mask.dtype == task.unlabeled_mask.dtype == torch.float32

    hp_r = jlocal.SSLHParams(epochs=epochs, batch_size=32)
    hp = tlocal.SSLHParams(epochs=epochs, batch_size=32)
    key = jax.random.PRNGKey(11)
    params_r, _ = jlocal.train_party_ssl(key, task_r, hp_r)
    sched = jlocal.build_schedule(key, n_o + n_u, n_u, hp_r)
    steps = sched.step_keys.shape[0]
    assert steps == 10 == tlocal.schedule_steps(n_o + n_u, hp)
    bs_l, bs_u = sched.idx_labeled.shape[1], sched.idx_unlabeled.shape[1]
    draws = [
        ref_ssl_draws(sched.step_keys[i], ref.ssl_cfg, (bs_l, 20), (bs_u, 20))
        for i in range(steps)
    ]
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    tlocal.train_party_ssl(task, hp, seed0, step_draws=draws)
    _assert_tree_close(bridge.to_jax_params(port.extractor), params_r.extractor, SESSION_RTOL)
    _assert_tree_close(bridge.to_jax_params(port.head), params_r.head, SESSION_RTOL)
    # and the session moved the parameters well beyond that tolerance
    start, end = jax.tree_util.tree_leaves(ref.params), jax.tree_util.tree_leaves(params_r)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(start, end))
    assert moved > 100 * SESSION_RTOL


def test_stochastic_gate_draws_from_the_given_generator():
    """Under ``fewshot_stochastic_gate`` the take mask is a Bernoulli(p̂)
    draw from the run's device generator (here the CPU's), seeded."""
    _, port = _clients(12)
    x_o, x_u = _t(_rand(13, (8, 20))), _t(_rand(14, (400, 20)))
    probs = torch.from_numpy(np.repeat(np.float32([0.0, 0.5, 1.0, 0.25]), 100))
    cfg = tproto.ProtocolConfig(fewshot_stochastic_gate=True)

    def take(seed):
        gen = torch.Generator().manual_seed(seed)
        y_o = torch.zeros(8, dtype=torch.long)
        return tproto.fewshot_task(port, x_o, x_u, probs, y_o, cfg, gen)[1]

    a = take(0)
    assert torch.equal(a, take(0)) and not torch.equal(a, take(1))
    assert set(a.unique().tolist()) <= {0.0, 1.0}
    assert a[:100].sum() == 0 and a[200:300].sum() == 100  # p̂ = 0 never, p̂ = 1 always
    assert 30 <= int(a[100:200].sum()) <= 70
