"""The party-process schedule (``repro_torch.launch.vfl_step``) against the
reference's shard_map schedule (``repro.launch.vfl_step``).

The reference runs in a fresh Python on a two-device CPU mesh
(``forced_host_devices(2)``, ``make_debug_mesh((2, 1, 1))``) and saves its
outputs and its compiled programs' collectives to an npz. The port runs the
same inputs as two gloo party processes, given the draws the reference
derives from its keys: k-means++ from ``fold_in(PRNGKey(0), rank)``, the
head from ``fold_in(PRNGKey(1), rank)`` and step i's augmentation from
``fold_in(fold_in(PRNGKey(2), rank), i)``. Every party process is spawned
by one of a few fixtures, each run once for the module.
"""

import inspect
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import vfl_step as jvfl
from repro.models import extractors as jx
from repro_torch import bridge, engine, scenarios
from repro_torch.core import clustering as tclust
from repro_torch.core import protocol as tproto
from repro_torch.core import ssl as tssl
from repro_torch.engine import local_ssl as tlocal
from repro_torch.launch import vfl_step
from repro_torch.models import extractors as tx

from test_torch_clustering import _assert_assignments_agree, _ref_seeding_draws
from test_torch_ssl import _assert_tree_close, _grad_tree, ref_ssl_draws

ROOT = Path(__file__).resolve().parents[1]
F, H, R, C, B, POOL, K = 20, 64, 16, 2, 32, 128, 2
VANILLA_STEPS = 5
LOCAL_STEPS = (0, 1, 10)
# Parameters after the vanilla steps, relative to their scale.
VANILLA_RTOL = 1e-5
# A session's SSL steps compound rounding through the momentum trace
# (test_torch_local_ssl.py's SESSION_RTOL).
SESSION_RTOL = 1e-4
LOSS_TOL = 1e-5
# the share of rows whose best two k-means distances may lie within the
# near-tie band (test_torch_clustering.py's NEAR_TIE)
MAX_TIE_SHARE = 0.1

REFERENCE = r"""
import re
import sys

import numpy as np

from repro.launch.mesh import forced_host_devices, make_debug_mesh

forced_host_devices(2)

import jax
import jax.numpy as jnp

from repro.core import clustering
from repro.core.ssl import cross_entropy
from repro.launch.vfl_step import (count_pod_collectives, make_oneshot_vfl_session,
                                   make_vanilla_vfl_step)
from repro.models.extractors import make_mlp_extractor

F, H, R, C, VANILLA_STEPS = (int(a) for a in sys.argv[3:8])
LOCAL_STEPS = [int(a) for a in sys.argv[8].split(",")]
inp = dict(np.load(sys.argv[1]))
params = {k: jnp.asarray(inp[k]) for k in ("w0", "b0", "w1", "b1")}
x, xu, y, wh = (jnp.asarray(inp[k]) for k in ("x", "x_u", "y", "w_head"))
COLL = re.compile(r"= ([a-z0-9]+)\[([0-9,]*)\][^\n]*? (all-gather|all-reduce|reduce-scatter|"
                  r"all-to-all|collective-permute)\(")
out = {}


def collectives(name, text):
    out[name + "/ops"] = np.array([f"{k} {dt} {dims}" for dt, dims, k in COLL.findall(text)])
    c = count_pod_collectives(text)
    out[name + "/count"] = np.array(c["pod_crossing"] + c["pod_internal"])


mesh = make_debug_mesh((2, 1, 1))
with mesh:
    vanilla = jax.jit(make_vanilla_vfl_step(mesh, F, H, R, C)).lower(params, x, y, wh).compile()
    collectives("vanilla", vanilla.as_text())
    p, losses = params, []
    for _ in range(VANILLA_STEPS):
        p, loss = vanilla(p, x, y, wh)
        losses.append(float(loss))
    out.update({f"vanilla/{k}": np.asarray(v) for k, v in p.items()})
    out["vanilla/losses"] = np.array(losses)
    for n in LOCAL_STEPS:
        session = jax.jit(make_oneshot_vfl_session(mesh, F, H, R, C, local_steps=n))
        compiled = session.lower(params, x, xu, y, wh).compile()
        collectives(f"oneshot{n}", compiled.as_text())
        wp, loss = compiled(params, x, xu, y, wh)
        out.update({f"oneshot{n}/{k}": np.asarray(v) for k, v in wp.items()})
        out[f"oneshot{n}/loss"] = np.asarray(loss)

# step 3 outside the session, as the session computes it: the mean of the
# parties' gradient slices, clustered with each party's key
ext = make_mlp_extractor(rep_dim=R, hidden=(H,))
joint = jnp.concatenate([ext.apply({k: v[i] for k, v in params.items()}, x[i]) for i in range(2)], 1)
g_joint = jax.grad(lambda j: jnp.mean(cross_entropy(j @ wh, y)))(joint)
g = (g_joint[:, :R] + g_joint[:, R:]) / 2
out["g_mean"] = np.asarray(g)
for rank in range(2):
    labels, centers = clustering.kmeans(jax.random.fold_in(jax.random.PRNGKey(0), rank), g, C, 8,
                                        False, restarts=1)
    out[f"pseudo{rank}"], out[f"centers{rank}"] = np.asarray(labels), np.asarray(centers)
np.savez(sys.argv[2], **out)
"""


def _rank(tree, r):
    return {k: np.asarray(v)[r] for k, v in tree.items()}


def _ops(records):
    """The port's collectives as the reference's (kind, type, element count)."""
    return [(op.kind, op.dtype, int(np.prod(op.shape))) for op in records]


def _ref_ops(names):
    dtypes = {"f32": "float32", "bf16": "bfloat16"}
    out = []
    for line in names:
        kind, dt, dims = str(line).split(" ")
        out.append((kind.replace("-", "_"), dtypes[dt], int(np.prod([int(d) for d in dims.split(",")]))))
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = {
        "w0": rng.standard_normal((K, F, H)) * np.sqrt(2.0 / F),
        "b0": 0.1 * rng.standard_normal((K, H)),
        "w1": rng.standard_normal((K, H, R)) * np.sqrt(2.0 / H),
        "b1": 0.1 * rng.standard_normal((K, R)),
    }
    data = {
        "x": rng.standard_normal((K, B, F)),
        "x_u": rng.standard_normal((K, POOL, F)),
        "w_head": 0.3 * rng.standard_normal((K * R, C)),
    }
    out = {k: v.astype(np.float32) for k, v in {**params, **data}.items()}
    out["y"] = rng.integers(0, C, B).astype(np.int32)
    return out


def _ref_draws(rank, steps):
    seeding = tclust.SeedingDraws(*_ref_seeding_draws(jax.random.fold_in(jax.random.PRNGKey(0), rank), 1, B, C))
    head = jx.make_classifier(C).init(jax.random.fold_in(jax.random.PRNGKey(1), rank), jnp.zeros((1, R)))
    k_ssl = jax.random.fold_in(jax.random.PRNGKey(2), rank)
    cfg = tssl.SSLConfig(modality="tabular")
    step_draws = [
        ref_ssl_draws(jax.random.fold_in(k_ssl, i), cfg, (B, F), (POOL, F)) for i in range(steps)
    ]
    return seeding, {k: np.asarray(v) for k, v in head.items()}, step_draws


def _split_jobs(name, dtypes):
    """A one-shot job of no local steps per party and ``rep_dtype`` on the
    catalog split ``name``, and the port's ``run_one_shot`` ledger bytes."""
    bundle = scenarios.build(name, seed=0, device="cpu")
    split = bundle.split
    spec = bundle.extractors[0]
    k = len(split.aligned)
    gen = torch.Generator().manual_seed(0)
    w_head = 0.3 * torch.randn(k * spec.rep_dim, split.num_classes, generator=gen)
    jobs = [[] for _ in range(k)]
    ledgers = []
    for dt in dtypes:
        cfg = tproto.ProtocolConfig(client_epochs=1, server_epochs=1, rep_dtype=dt)
        res = tproto.run_one_shot(0, split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cpu")
        ledgers.append(res.ledger.total_bytes())
        for r in range(k):
            jobs[r].append(vfl_step.PartyJob(
                "oneshot", split.aligned[r], split.labels, w_head, 0, spec.hidden[0], spec.rep_dim,
                x_u=split.unaligned[r], rep_dtype=dt,
            ))
    return jobs, ledgers


BYTE_DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The reference's npz (its subprocess runs while the port's party
    processes do) and each rank's port results: [vanilla 5 steps, vanilla 1
    step, one-shot at each LOCAL_STEPS, then hard/overlap-32's one-shot in
    f32 and bf16]; and fault/none's four ranks, f32 and bf16."""
    tmp = tmp_path_factory.mktemp("vfl_step")
    np.savez(tmp / "in.npz", **inputs)
    (tmp / "reference.py").write_text(REFERENCE)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    argv = [str(a) for a in (F, H, R, C, VANILLA_STEPS)] + [",".join(map(str, LOCAL_STEPS))]
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "in.npz"), str(tmp / "out.npz"), *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        hard_jobs, hard_ledgers = _split_jobs("hard/overlap-32", BYTE_DTYPES)
        fault_jobs, fault_ledgers = _split_jobs("fault/none", BYTE_DTYPES)
        y, w_head = torch.from_numpy(inputs["y"]), torch.from_numpy(inputs["w_head"])
        rank_jobs = []
        for r in range(K):
            seeding, head, step_draws = _ref_draws(r, max(LOCAL_STEPS))
            common = dict(y=y, w_head=w_head, hidden=H, rep_dim=R, extractor=_rank(
                {k: inputs[k] for k in ("w0", "b0", "w1", "b1")}, r))
            x = torch.from_numpy(inputs["x"][r])
            jobs = [vfl_step.PartyJob("vanilla", x, steps=n, **common) for n in (VANILLA_STEPS, 1)]
            jobs += [
                vfl_step.PartyJob(
                    "oneshot", x, steps=n, x_u=torch.from_numpy(inputs["x_u"][r]), head=head,
                    seeding=seeding, step_draws=step_draws[:n], **common,
                )
                for n in LOCAL_STEPS
            ]
            rank_jobs.append(("cpu", jobs + hard_jobs[r]))
        with ThreadPoolExecutor(1) as pool:  # the two groups run at once
            four = pool.submit(
                vfl_step.run_parties, vfl_step.run_party_jobs, [("cpu", j) for j in fault_jobs]
            )
            port = vfl_step.run_parties(vfl_step.run_party_jobs, rank_jobs)
            four = four.result()
        log, _ = ref.communicate(timeout=240)
    finally:
        ref.kill()
    assert ref.returncode == 0, log
    return {
        "ref": dict(np.load(tmp / "out.npz")),
        "port": port,
        "bytes": {2: ([rank[-2:] for rank in port], hard_ledgers), 4: (four, fault_ledgers)},
    }


# ------------------------------------------------------------------ parity
def test_vanilla_steps_match_reference(runs, inputs):
    ref = runs["ref"]
    for r, results in enumerate(runs["port"]):
        got = results[0]
        _assert_tree_close(got["extractor"], _rank({k: ref[f"vanilla/{k}"] for k in "w0 b0 w1 b1".split()}, r), VANILLA_RTOL)
        np.testing.assert_allclose(got["losses"], ref["vanilla/losses"], atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("n", LOCAL_STEPS)
def test_oneshot_session_matches_reference(runs, n):
    """Pseudo-labels equal outside near-ties, the final extractor within
    SESSION_RTOL of the parameters' scale, and the final loss."""
    ref = runs["ref"]
    want_params = {k: ref[f"oneshot{n}/{k}"] for k in ("w0", "b0", "w1", "b1")}
    for r, results in enumerate(runs["port"]):
        got = results[2 + LOCAL_STEPS.index(n)]
        g = ref["g_mean"]
        xn = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
        _assert_assignments_agree(got["pseudo"], ref[f"pseudo{r}"], xn, ref[f"centers{r}"], MAX_TIE_SHARE)
        _assert_tree_close(got["extractor"], _rank(want_params, r), SESSION_RTOL)
        assert abs(got["loss"] - float(ref[f"oneshot{n}/loss"])) <= LOSS_TOL


# ------------------------------------------------------------------ counts
@pytest.mark.parametrize("n", LOCAL_STEPS)
def test_oneshot_session_makes_three_collectives(runs, n):
    """Three at every local_steps, with the reference's kinds and shapes.
    At 0 local steps the reference's compiled program holds one: ③'s labels
    are dead and ⑤ gathers what ① gathered, so XLA drops ② and merges the
    two gathers. The party processes run the protocol's three."""
    ref = runs["ref"]
    ref_ops = _ref_ops(ref[f"oneshot{n}/ops"])
    if n == 0:
        assert int(ref["oneshot0/count"]) == 1 and ref_ops == _ref_ops(ref["oneshot1/ops"])[:1]
        ref_ops = _ref_ops(ref["oneshot1/ops"])
    else:
        assert int(ref[f"oneshot{n}/count"]) == 3
    for results in runs["port"]:
        got = results[2 + LOCAL_STEPS.index(n)]
        assert [op.kind for op in got["ops"]] == ["all_gather", "all_reduce", "all_gather"]
        assert got["counts"]["pod_crossing"] == 3 and got["counts"]["pod_internal"] == 0
        assert _ops(got["ops"]) == ref_ops
        assert got["counts"]["pod_crossing_bytes"] == sum(op.bytes for op in got["ops"])
        assert got["kmeans_launches"] == 0  # the plain version on the CPU


@pytest.mark.parametrize("index,steps", [(0, VANILLA_STEPS), (1, 1)])
def test_vanilla_makes_two_collectives_a_step(runs, index, steps):
    ref_ops = _ref_ops(runs["ref"]["vanilla/ops"])
    assert int(runs["ref"]["vanilla/count"]) == 2
    for results in runs["port"]:
        got = results[index]
        assert [op.kind for op in got["ops"]] == ["all_gather", "reduce_scatter"] * steps
        assert got["counts"]["pod_crossing"] == 2 * steps
        assert _ops(got["ops"]) == ref_ops * steps


@pytest.mark.parametrize("parties", [2, 4])
@pytest.mark.parametrize("dtype", BYTE_DTYPES, ids=str)
def test_oneshot_payload_bytes_equal_the_one_shot_ledger(runs, parties, dtype):
    """What the parties put into the three collectives, summed over the
    parties, is ``run_one_shot``'s ledger for the same K, N_o, r and type:
    hard/overlap-32 (K = 2) and fault/none (K = 4)."""
    results, ledgers = runs["bytes"][parties]
    i = BYTE_DTYPES.index(dtype)
    sent = sum(op.payload for rank in results for op in rank[i]["ops"])
    assert sent == ledgers[i]
    assert {op.dtype for rank in results for op in rank[i]["ops"]} == {str(dtype).removeprefix("torch.")}
    if parties == 2:
        assert ledgers == [12288, 6144]


# ------------------------------------------ behaviours mirrored on purpose
@pytest.fixture(scope="module")
def joint_grads(inputs):
    """The joint loss in one process over the port's modules: each party's
    extractor (its .grad filled) and the gradient of the loss with respect
    to the joint representations (B, K·R)."""
    exts = []
    for r in range(K):
        ext = tx.make_mlp_extractor(F, R, (H,))
        bridge.load_jax_params(ext, _rank({k: inputs[k] for k in ("w0", "b0", "w1", "b1")}, r))
        exts.append(ext)
    joint = torch.cat([e(torch.from_numpy(inputs["x"][r])) for r, e in enumerate(exts)], 1)
    joint.retain_grad()
    logits = joint @ torch.from_numpy(inputs["w_head"])
    tssl.cross_entropy(logits, torch.from_numpy(inputs["y"])).mean().backward()
    return exts, joint.grad


def test_each_party_receives_the_mean_of_the_gradient_slices(runs, joint_grads):
    """Exchange ②: every party receives the psum of the parties' slices over
    K, one matrix for all, not its own slice."""
    _, g_joint = joint_grads
    slices = [g_joint[:, r * R : (r + 1) * R].numpy() for r in range(K)]
    mean = sum(slices) / K
    got = [results[2]["partial_grads"] for results in runs["port"]]
    for r in range(K):
        np.testing.assert_array_equal(got[r], got[0])
        np.testing.assert_allclose(got[r], mean, atol=1e-7, rtol=0)
        assert np.abs(got[r] - slices[r]).max() > 1e-3
    np.testing.assert_allclose(runs["ref"]["g_mean"], mean, atol=1e-7, rtol=0)


def test_vanilla_update_is_k_times_the_joint_gradient(runs, joint_grads):
    """Every party computes the same joint loss, so the gather's transpose
    sums K equal cotangents: one step moves each extractor by lr·K·∇."""
    exts, _ = joint_grads
    for r, ext in enumerate(exts):
        after = runs["port"][r][1]["extractor"]
        before = bridge.to_jax_params(ext)
        grads = _grad_tree(ext)
        for k in before:
            assert np.abs(grads[k]).max() > 0
            step = (before[k] - after[k]) / 0.01
            np.testing.assert_allclose(step, K * grads[k], atol=1e-4, rtol=1e-4)
            assert np.abs(step - grads[k]).max() > 1e-3  # not the one-loss gradient


# ----------------------------------------------------------- failure paths
def test_a_rank_that_raises_fails_the_call_within_the_deadline(inputs):
    """Rank 1 refuses its job while rank 0 waits in the first collective:
    the call raises with rank 1's error and kills rank 0."""
    y, w_head = torch.from_numpy(inputs["y"]), torch.from_numpy(inputs["w_head"])
    job = dict(y=y, w_head=w_head, steps=1, hidden=H, rep_dim=R)
    good = vfl_step.PartyJob("vanilla", torch.from_numpy(inputs["x"][0]), **job)
    bad = vfl_step.PartyJob("no-such-kind", torch.from_numpy(inputs["x"][1]), **job)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="unknown party job kind"):
        vfl_step.run_parties(vfl_step.run_party_jobs, [("cpu", [good]), ("cpu", [bad])])
    assert time.monotonic() - t0 < vfl_step.PARTY_TIMEOUT_S


def test_a_group_past_its_deadline_is_killed(inputs):
    y, w_head = torch.from_numpy(inputs["y"]), torch.from_numpy(inputs["w_head"])
    job = vfl_step.PartyJob("vanilla", torch.from_numpy(inputs["x"][0]), y, w_head, 1, H, R)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        vfl_step.run_parties(vfl_step.run_party_jobs, [("cpu", [job])] * 2, timeout=0.5)
    assert time.monotonic() - t0 < 10


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")


def test_main_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vfl_step.main([])


# -------------------------------------------------------------- the engine
def test_vfl_step_shares_the_engine_step():
    """The schedule trains with the engine's step and the port's MLP
    extractor, with no private re-implementation (the reference's
    tests/test_engine.py::test_vfl_step_shares_engine_implementation)."""
    assert vfl_step.make_ssl_step_fn is engine.make_ssl_step_fn is tlocal.make_ssl_step_fn
    assert vfl_step.make_ssl_optimizer is engine.make_ssl_optimizer
    assert vfl_step.PartyParams is engine.PartyParams
    assert not hasattr(vfl_step, "_extract")
    src = inspect.getsource(vfl_step)
    assert "make_mlp_extractor" in src
    assert "gradient_pseudo_labels" in src


def test_extractor_shapes_match_reference():
    got = vfl_step.extractor_shapes(F, H, R, K)
    want = jvfl.extractor_shapes(F, H, R, K)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape) and v.dtype == torch.float32
        assert v.device.type == "meta" and want[k].dtype == jnp.float32


def test_train_party_ssl_is_a_loop_of_the_engine_step():
    """``train_party_ssl`` equals a hand loop of ``make_ssl_step_fn`` over
    the same schedule and draws, bit for bit."""
    rng = np.random.default_rng(3)
    x_l = torch.from_numpy(rng.standard_normal((40, F), dtype=np.float32))
    y_l = torch.from_numpy(rng.integers(0, C, 40))
    x_u = torch.from_numpy(rng.standard_normal((90, F), dtype=np.float32))
    cfg = tssl.SSLConfig(modality="tabular", confidence_threshold=0.6)
    hp = tlocal.SSLHParams(epochs=3, batch_size=16)
    models = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        models.append((tx.make_mlp_extractor(F, R, (H,)).init_(gen), tx.make_classifier(R, C).init_(gen)))
    task = tlocal.PartyTask(models[0][0], models[0][1], cfg, x_l, y_l, x_u, feature_mean=x_u.mean(0))
    draws = tlocal.draw_session(task, hp, torch.Generator().manual_seed(11))
    tlocal.train_party_ssl(task, hp, 5, step_draws=draws)

    ext, head = models[1]
    params = engine.PartyParams(ext, head)
    opt = engine.make_ssl_optimizer(hp, params)
    step = engine.make_ssl_step_fn(ext, head, cfg)
    sched = tlocal.build_schedule(5, 40, 90, hp)
    assert len(draws) == sched.idx_labeled.shape[0] > 0
    for i, d in enumerate(draws):
        il, iu = torch.from_numpy(sched.idx_labeled[i]), torch.from_numpy(sched.idx_unlabeled[i])
        step(params, opt, x_u.mean(0), d, x_l[il], y_l[il], x_u[iu])
    for a, b in zip([*task.extractor.parameters(), *task.head.parameters()], opt.params):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="modules it was built from"):
        step(engine.PartyParams(task.extractor, head), opt, x_u.mean(0), draws[0], x_l, y_l, x_u)
