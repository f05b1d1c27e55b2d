"""The port's fault injection (``repro_torch.core.faults`` and the runners'
``fault`` argument) against the reference's fault helpers
(``repro.core.protocol``, ``repro.engine``), on the CPU.

* ``dp_noised`` on the reference's own draws (``normal(fold_in(fold_in(
  PRNGKey(s), 15485863), phase))``) equals ``_dp_noised``;
* ``reconstruct_dropped`` and ``faulted_test_reps`` equal the reference's
  (the jnp route and the Pallas kernel in interpret mode) for a dropout at
  every stage, stale zeros included;
* ``fault_step_valid``, ``drop_skip`` and ``fault_diags`` equal the
  reference's for every fault member, party and protocol point;
* a 10-step SSL session under a commit mask and the three baselines' steps
  with a commit horizon end at the reference's state;
* ``fault=None``, dp noise at σ = 0 and a straggler at fraction 1.0 are the
  fault-free run bit for bit; few-shot + finetune refuses a fault.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import scenarios as jscen
from repro.core import baselines as jbase
from repro.core import protocol as jproto
from repro.core import ssl as jssl
from repro.engine import iterative as jiter
from repro.engine import local_ssl as jlocal
from repro.models import extractors as jx
from repro_torch import bridge, scenarios
from repro_torch.core import baselines as tbase
from repro_torch.core import faults
from repro_torch.core import protocol as tproto
from repro_torch.core import ssl as tssl
from repro_torch.data import split_from_numpy
from repro_torch.engine import iterative as titer
from repro_torch.engine import local_ssl as tlocal
from repro_torch.models import extractors as tx
from repro_torch.scenarios.faults import POINT_EVAL, POINT_ROUND2, POINT_UPLOAD2, FaultSpec

from test_torch_iterative import (  # noqa: F401 (reference_state: a fixture)
    _port_models,
    reference_state,
)
from test_torch_ssl import _assert_tree_close, _rand, _ref_params, _t, ref_ssl_draws

# σ · std · N(0, 1) on O(1) payloads, one product and one add in f32
DP_TOL = 1e-6
# Eq. 10 on O(1) reps (32 keys of width 16): a few f32 ulps
EQ10_TOL = 1e-5
# ten SGD steps of f32 MLPs, summed in other orders (test_torch_iterative.py)
STEP_TOL = 1e-5
SESSION_RTOL = 1e-5
MASK = [1, 1, 0, 1, 0, 0, 1, 1, 0, 0]
ACTIVE = 6
FAULT_NAMES = [n for n in jscen.names() if n.startswith("fault/")]
FAULTED = [n for n in FAULT_NAMES if jscen.get(n).fault is not None]
DROPOUTS = [n for n in FAULT_NAMES if "/dropout-" in n]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one intra-op thread runs them faster than a
    spinning pool, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fkey(seed):
    return jax.random.fold_in(jax.random.PRNGKey(seed), faults.FAULT_STREAM)


def _ref_noise(seed, phase, shape):
    return _t(jax.random.normal(jax.random.fold_in(_fkey(seed), phase), shape))


def _reps(seed, k=4, n=32, d=16):
    return [_rand(seed + j, (n, d)) for j in range(k)]


# ------------------------------------------------------------- dp noise
@pytest.mark.parametrize("phase", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("sigma", [0.1, 0.5])
def test_dp_noised_on_the_references_draws(phase, sigma):
    fault = FaultSpec("dp_upload", party=1, dp_sigma=sigma)
    ref_fault = jscen.FaultSpec("dp_upload", party=1, dp_sigma=sigma)
    arr = 3.0 * _rand(phase, (40, 16)) + 1.0
    want = jproto._dp_noised(_fkey(7), phase, 1, ref_fault, jnp.asarray(arr))
    got = faults.dp_noised(_t(arr), fault, 1, _ref_noise(7, phase, arr.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DP_TOL, rtol=0)
    assert not np.allclose(got.numpy(), arr)
    # another party, σ = 0 or another kind: the payload itself, nothing drawn
    for other, party in ((fault, 0), (FaultSpec("dp_upload", party=1), 1),
                         (FaultSpec("straggler", party=1), 1), (None, 1)):
        t = _t(arr)
        assert faults.dp_noised(t, other, party, None) is t
        assert faults.dp_upload(t, other, party, 0, phase) is t


def test_fault_generators_are_seeded_per_run_and_phase():
    like = torch.zeros(64, 16)
    a = faults.fault_noise(3, 1, like)
    assert torch.equal(a, faults.fault_noise(3, 1, like))
    assert not torch.equal(a, faults.fault_noise(3, 2, like))
    assert not torch.equal(a, faults.fault_noise(4, 1, like))
    # never the run's own streams: those are seeded seed (CPU) and seed + 7919
    host, draws = tproto._generators(3, torch.device("cpu"))
    for gen in (host, draws):
        assert not torch.equal(a, torch.randn(64, 16, generator=gen))


# ----------------------------------------------------- Eq. 10 reconstruction
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("point", [POINT_UPLOAD2, POINT_ROUND2])
@pytest.mark.parametrize("name", DROPOUTS)
def test_reconstruct_dropped_equals_the_references(name, point, use_kernels):
    fault = scenarios.get(name).fault
    reps, stale = _reps(10), _reps(20)
    if fault.stage == "pre_upload":
        stale[fault.party] = np.zeros_like(stale[fault.party])  # never uploaded
    ref_reps = [[jnp.asarray(r) for r in reps]]
    jproto._reconstruct_dropped(ref_reps, [[jnp.asarray(s) for s in stale]],
                                [jscen.get(name).fault], point, use_kernels)
    record = []
    got = faults.reconstruct_dropped([_t(r) for r in reps], [_t(s) for s in stale], fault, point,
                                     record)
    for k in range(4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_reps[0][k]), atol=EQ10_TOL,
                                   rtol=0)
    dropped = [k for k in range(4) if fault.drops(k, point)]
    assert [r["party"] for r in record] == dropped
    for r in record:
        assert r["anchor"] == 0 and r["point"] == point
        assert torch.equal(r["estimate"], got[r["party"]])
    if dropped and fault.stage == "pre_upload":
        assert not got[fault.party].any()  # stale zeros rebuild to zeros
    elif dropped:
        assert got[fault.party].abs().max() > 0.05
    assert all(torch.equal(got[k], _t(reps[k])) for k in range(4) if k not in dropped)


@pytest.mark.parametrize("h_o", ["final", "none"])
@pytest.mark.parametrize("name", FAULTED)
def test_faulted_test_reps_equal_the_references(name, h_o):
    fault = scenarios.get(name).fault
    test_reps, h_o_final = _reps(30, n=60), _reps(40)
    ref = jproto._faulted_test_reps(
        [jnp.asarray(r) for r in test_reps], jscen.get(name).fault,
        None if h_o == "none" else [jnp.asarray(r) for r in h_o_final],
        _fkey(5), False)
    noise = _ref_noise(5, faults.PHASE_TEST, test_reps[fault.party].shape)
    got = faults.faulted_test_reps(
        [_t(r) for r in test_reps], fault, None if h_o == "none" else [_t(r) for r in h_o_final],
        noise if faults.dp_applies(fault, fault.party) else None)
    for k in range(4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=EQ10_TOL, rtol=0)
    if fault.kind == "dropout" and h_o == "none":
        assert not got[fault.party].any()


# ------------------------------------------------------- masks and flags
@pytest.mark.parametrize("name", FAULT_NAMES)
def test_step_masks_skips_and_diagnostics_equal_the_references(name):
    fault = scenarios.get(name).fault
    ref_fault = jscen.get(name).fault
    for epochs, n_labeled in ((20, 32), (20, 624), (3, 100), (1, 5)):
        hp = tlocal.SSLHParams(epochs=epochs)
        hp_r = jengine.SSLHParams(epochs=epochs)
        for party in range(4):
            for skip_all in (False, True):
                got = faults.fault_step_valid(fault, party, n_labeled, hp, skip_all)
                want = jproto._fault_step_valid(ref_fault, party, n_labeled, hp_r, skip_all)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for party in range(4):
        for point in range(POINT_EVAL + 1):
            want = jproto._drop_skip(None if ref_fault is None else [ref_fault], party, point, 1)
            got = faults.drop_skip(fault, party, point)
            assert got == (False if want is None else want[0])
    assert faults.fault_diags(fault, 4, 0.75) == jproto._fault_diags(ref_fault, 4, 0.75)


def test_straggler_mask_keeps_whole_epochs():
    fault = FaultSpec("straggler", party=1, epoch_fraction=0.5)
    sv = faults.fault_step_valid(fault, 1, 624, tlocal.SSLHParams(epochs=20), False)
    assert sv.shape == (380,) and sv[:190].all() and not sv[190:].any()
    assert faults.fault_step_valid(fault, 0, 624, tlocal.SSLHParams(epochs=20), False).all()


# ---------------------------------------------------- the masked SSL session
def test_masked_ssl_session_equals_the_references():
    """Ten steps under the commit mask MASK: an invalid step draws and
    computes but moves neither the parameters nor the momentum, so the
    valid step after it (step 3, then step 6) starts from the frozen
    momentum; a coasting momentum would part from the reference there."""
    fshape, n_l, n_u, epochs = (20,), 32, 200, 10
    ref_e, port_e = jx.make_mlp_extractor(16, (64,)), tx.make_mlp_extractor(20, 16, (64,))
    ref_h, port_h = jx.make_classifier(2), tx.make_classifier(16, 2)
    cfg = jssl.SSLConfig(modality="tabular", confidence_threshold=0.6)
    tcfg = tssl.SSLConfig(modality="tabular", confidence_threshold=0.6)
    x_l, x_u = _rand(50, (n_l, *fshape)), _rand(51, (n_u, *fshape))
    y = np.random.default_rng(52).integers(0, 2, n_l)
    fm = x_u.mean(0)
    pe = _ref_params(ref_e, x_l, 53, scale=0.3)
    ph = _ref_params(ref_h, np.zeros((1, 16), np.float32), 54, scale=0.3)
    bridge.load_jax_params(port_e, pe)
    bridge.load_jax_params(port_h, ph)
    hp_r = jlocal.SSLHParams(epochs=epochs, batch_size=32)
    hp = tlocal.SSLHParams(epochs=epochs, batch_size=32)
    key = jax.random.PRNGKey(55)
    task_r = jlocal.PartyTask(
        extractor=ref_e, head=ref_h, params=jlocal.PartyParams(pe, ph), ssl_cfg=cfg,
        x_labeled=jnp.asarray(x_l), y_pseudo=jnp.asarray(y), x_unlabeled=jnp.asarray(x_u),
        feature_mean=jnp.asarray(fm), step_valid=jnp.asarray(MASK, jnp.float32),
    )
    params_r, metrics_r = jlocal.train_party_ssl(key, task_r, hp_r)
    sched = jlocal.build_schedule(key, n_l, n_u, hp_r)
    assert sched.step_keys.shape[0] == len(MASK)
    bs_l, bs_u = sched.idx_labeled.shape[1], sched.idx_unlabeled.shape[1]
    draws = [
        ref_ssl_draws(sched.step_keys[i], cfg, (bs_l, *fshape), (bs_u, *fshape))
        for i in range(len(MASK))
    ]
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    task = tlocal.PartyTask(port_e, port_h, tcfg, _t(x_l), _t(y), _t(x_u), _t(fm),
                            step_valid=torch.tensor(MASK, dtype=torch.float32))
    metrics = tlocal.train_party_ssl(task, hp, seed0, step_draws=draws)
    _assert_tree_close(bridge.to_jax_params(port_e), params_r.extractor, SESSION_RTOL)
    _assert_tree_close(bridge.to_jax_params(port_h), params_r.head, SESSION_RTOL)
    # the last step is invalid: its metrics are still computed and reported
    for k, v in metrics_r.items():
        assert abs(metrics[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, metrics[k], v)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(params_r), jax.tree_util.tree_leaves(
                    jlocal.PartyParams(pe, ph))))
    assert moved > 100 * SESSION_RTOL


def test_all_zero_mask_commits_nothing_and_a_short_mask_is_refused():
    ext, head = tx.make_mlp_extractor(20, 16, (64,)), tx.make_classifier(16, 2)
    gen = torch.Generator().manual_seed(0)
    ext.init_(gen)
    head.init_(gen)
    before = [p.clone() for m in (ext, head) for p in m.parameters()]
    cfg = tssl.SSLConfig(modality="tabular")
    x_l, x_u = _t(_rand(60, (32, 20))), _t(_rand(61, (64, 20)))
    y = torch.zeros(32, dtype=torch.long)
    hp = tlocal.SSLHParams(epochs=4)
    task = tlocal.PartyTask(ext, head, cfg, x_l, y, x_u, x_u.mean(0), step_valid=torch.zeros(4))
    metrics = tlocal.train_party_ssl(task, hp, 1, generator=torch.Generator().manual_seed(1))
    assert set(metrics) == {"loss", "l_s", "l_u", "pseudo_mask_rate"}
    assert all(torch.equal(a, b) for a, b in zip(before, [p for m in (ext, head)
                                                            for p in m.parameters()]))
    task = dataclasses.replace(task, step_valid=torch.ones(3))
    with pytest.raises(ValueError, match="3 step_valid entries for a 4-step schedule"):
        tlocal.train_party_ssl(task, hp, 1, generator=torch.Generator())


# ------------------------------------------ the baselines' commit horizon
@pytest.mark.parametrize("kind", ["splitnn", "fedbcd", "fedcvt"])
def test_commit_horizon_equals_the_references(reference_state, kind):
    """Ten steps with only the first ACTIVE committing, in both packages
    from the same parameters over the same schedules: the reference's
    ``run_iterative_session_seeds(active_steps=...)`` (its Python loop over
    the jitted step). Every loss, the four frozen ones included, and the
    final state agree."""
    bundle, clients, server = reference_state
    split = bundle.split
    cfg = jbase.IterativeConfig(fedbcd_q=3, fedcvt_threshold=0.75)
    hp = cfg.iter_hparams()
    j_ext = [c.extractor for c in clients]
    q = cfg.fedbcd_q if kind == "fedbcd" else None
    make = {
        "splitnn": lambda: jiter.make_splitnn_step_fn(j_ext, server.classifier, hp),
        "fedcvt": lambda: jiter.make_fedcvt_step_fn(j_ext, server.classifier, hp),
        "fedbcd": lambda: jiter.make_fedbcd_step_fn(j_ext, server.classifier, hp, q),
    }[kind]
    sched = np.asarray(jiter.build_iteration_schedule(4321, 32, 32, len(MASK)))
    u_sched = [np.asarray(u) for u in jiter.build_unaligned_schedule(
        0, [u.shape[0] for u in split.unaligned], 32, len(MASK))]
    carry = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None],
                                   jbase._session_carry(clients, server, cfg))
    has_u = kind == "fedcvt"
    out, losses_r = jiter.run_iterative_session_seeds(
        jiter.session_cache_key(kind, j_ext, server.classifier, hp, q), make, carry,
        tuple(jnp.asarray(x)[None] for x in split.aligned), jnp.asarray(split.labels)[None],
        jnp.asarray(sched)[None], mode="python",
        xs_u=tuple(jnp.asarray(u)[None] for u in split.unaligned) if has_u else None,
        u_schedules=tuple(jnp.asarray(u)[None] for u in u_sched) if has_u else None,
        active_steps=jnp.asarray([ACTIVE], jnp.int32))

    t_split = split_from_numpy(split, device="cpu")
    exts, clf = _port_models(clients, server)
    t_make = {
        "splitnn": lambda: titer.make_splitnn_step_fn(exts, clf, hp),
        "fedcvt": lambda: titer.make_fedcvt_step_fn(exts, clf, hp),
        "fedbcd": lambda: titer.make_fedbcd_step_fn(exts, clf, hp, q),
    }[kind]
    losses = titer.run_iterative_session(
        t_make(), t_split.aligned, t_split.labels, sched,
        t_split.unaligned if has_u else None, u_sched if has_u else None, active_steps=ACTIVE)
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_r[0]), atol=STEP_TOL,
                               rtol=STEP_TOL)
    # past the horizon nothing moves: the state is the first ACTIVE steps' bit for bit
    exts6, clf6 = _port_models(clients, server)
    step6 = {"splitnn": titer.make_splitnn_step_fn, "fedcvt": titer.make_fedcvt_step_fn}.get(
        kind, lambda e, c, h: titer.make_fedbcd_step_fn(e, c, h, q))(exts6, clf6, hp)
    titer.run_iterative_session(step6, t_split.aligned, t_split.labels, sched[:ACTIVE],
                                t_split.unaligned if has_u else None,
                                [u[:ACTIVE] for u in u_sched] if has_u else None)
    for a, b in zip((*exts, clf), (*exts6, clf6)):
        assert all(torch.equal(p, p6) for p, p6 in zip(a.parameters(), b.parameters()))
    for k, e in enumerate(exts):
        got, want = bridge.to_jax_params(e), out[0][k].extractor
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key][0]), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=f"{kind} party {k} {key}")
    got = bridge.to_jax_params(clf)
    for key in out[1]:
        np.testing.assert_allclose(got[key], np.asarray(out[1][key][0]), atol=STEP_TOL,
                                   rtol=STEP_TOL, err_msg=f"{kind} classifier {key}")


# ------------------------------------------- the fault-free path, bit for bit
TINY = dict(client_epochs=2, server_epochs=2)
NO_OP_FAULTS = {
    "none": None,
    "dp-sigma-0": FaultSpec("dp_upload", party=1, dp_sigma=0.0),
    "straggler-1.0": FaultSpec("straggler", party=1, epoch_fraction=1.0),
}


@pytest.fixture(scope="module")
def fault_free_bundle():
    return scenarios.build("fault/none", seed=0, device="cpu")


def _state(res):
    return [p.detach().clone() for c in res.clients for m in (c.extractor, c.head)
            for p in m.parameters()] + [p.detach().clone()
                                         for p in res.server.classifier.parameters()]


@pytest.mark.parametrize("runner", ["run_one_shot", "run_few_shot", "run_vanilla"])
@pytest.mark.parametrize("fault", list(NO_OP_FAULTS), ids=list(NO_OP_FAULTS))
def test_a_no_op_fault_is_the_fault_free_run(fault_free_bundle, runner, fault):
    """``fault=None``, dp noise at σ = 0 and a straggler at fraction 1.0
    draw nothing of their own and commit every step: metric, parameters
    and ledger equal the run without the argument bit for bit (the
    iterative loop runs a straggler fault-free, ``fault_modeled`` False)."""
    b = fault_free_bundle
    if runner == "run_vanilla":
        fn, cfg = getattr(tbase, runner), tbase.IterativeConfig(iterations=12)
    else:
        fn, cfg = getattr(tproto, runner), tproto.ProtocolConfig(**TINY)
    args = (0, b.split, b.extractors, b.ssl_cfgs, cfg)
    plain = fn(*args, device="cpu")
    res = fn(*args, device="cpu", fault=NO_OP_FAULTS[fault])
    assert res.metric == plain.metric
    assert [e.__dict__ for e in res.ledger.events] == [e.__dict__ for e in plain.ledger.events]
    assert all(torch.equal(a, b) for a, b in zip(_state(res), _state(plain)))
    spec = NO_OP_FAULTS[fault]
    if spec is None:
        assert "fault_kind" not in res.diagnostics
    else:
        assert res.diagnostics["fault_kind"] == spec.kind
        assert res.diagnostics["parties_survived"] == 4
        assert res.diagnostics["degraded_metric"] == res.metric
        if runner == "run_vanilla":
            assert res.diagnostics["fault_modeled"] is False


def test_few_shot_finetune_refuses_a_fault(fault_free_bundle):
    b = fault_free_bundle
    fault = FaultSpec("dropout", party=1, stage="pre_ssl")
    with pytest.raises(ValueError, match="does not support fault injection"):
        tproto.run_few_shot_finetune(0, b.split, b.extractors, b.ssl_cfgs,
                                     tproto.ProtocolConfig(**TINY), device="cpu", fault=fault)
