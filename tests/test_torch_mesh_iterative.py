"""The batch mesh over the iterative baselines' stacked session.

Counterpart of the ``run_vanilla`` cases of ``tests/test_sharded_frontier.py``
for SplitNN, FedBCD and FedCVT, at ``tests/test_torch_mesh.py``'s sizes: the
reference's ``make_tabular_credit(PRNGKey(5000), 700)`` split through numpy
(rule (a)), N_o 48, features 11 / 11, MLP extractors (rep 8, hidden 16),
60 iterations (FedBCD: 12 rounds of Q = 5), engine mode "vmap". The port's
mesh repeats the CPU in its slots, which runs the same pad, split, per-slot
and gather path as distinct devices would. What is held here:

* (a) each baseline on 2 slots equals the unsharded fold over seeds 0-1 at
  1e-5 on the metric, every loss and every leaf, with equal ledgers and
  ``device_fold`` 2 against 1;
* (b) 3 seeds on 2 slots (3 → 4 entries) and on 4 slots (3 → 4, one real
  entry a slot), entry by entry;
* (c) the stacked path's first sharded run takes one fresh mesh-keyed
  ``"iterative"`` miss; a new width on the same mesh shape and the
  unsharded run after it take none;
* (d) the per-entry loop ignores the mesh: ``device_fold`` 1, equal
  results, no fresh miss;
* (e) a faulted fold shards too, its stalls falling on both slots;
* (f) the sharded ledgers equal the reference's unsharded ``run_seeds``;
* (g) few-shot + finetune over seeds 0-3 under ``ProtocolConfig(mesh=2)``
  equals the unsharded chain, and its finetune session runs on the mesh;
* (h) a CUDA mesh without a card, a mixed mesh, a mesh that is not one and
  a mesh of the other device type than the fold are refused.

The card's case is
``tests/test_torch_gpu.py::test_two_slots_of_one_card_equal_the_unsharded_vanilla_fold``.
"""

import dataclasses

import jax
import pytest
import torch

from repro.core import IterativeConfig as RefIterConfig
from repro.core import SSLConfig as RefSSL
from repro.core import run_fedbcd as ref_fedbcd
from repro.core import run_fedcvt as ref_fedcvt
from repro.core import run_vanilla as ref_vanilla
from repro.core.protocol import run_seeds as ref_run_seeds
from repro.models import make_mlp_extractor
from repro_torch.core.baselines import IterativeConfig, run_fedbcd, run_fedcvt, run_vanilla
from repro_torch.core.protocol import run_few_shot_finetune, run_seeds
from repro_torch.engine import sessions
from repro_torch.launch.mesh import BatchMesh
from repro_torch.scenarios.faults import FaultSpec

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_mesh import FAST, SPECS, SSL, TOL, _assert_parity, _mesh, _ref_splits, _splits

ITER = IterativeConfig(iterations=60, engine_mode="vmap")
RUNNERS = {"vanilla": run_vanilla, "fedbcd": run_fedbcd, "fedcvt": run_fedcvt}
REF_RUNNERS = {"vanilla": ref_vanilla, "fedbcd": ref_fedbcd, "fedcvt": ref_fedcvt}


def _run(method, seeds, cfg=ITER, **kw):
    n = len(seeds)
    return run_seeds(
        RUNNERS[method], list(seeds), _splits(seeds), [SPECS] * n, [SSL] * n, cfg, device="cpu", **kw
    )


def _leaves(res):
    mods = [c.extractor for c in res.clients] + [res.server.classifier]
    return [p.detach() for m in mods for p in m.parameters()]


def _assert_same(sharded, single):
    assert len(sharded) == len(single)
    for a, b in zip(sharded, single):
        assert abs(a.metric - b.metric) <= TOL, (a.metric, b.metric)
        assert events(a.ledger) == events(b.ledger)
        assert a.ledger.summary() == b.ledger.summary()
        torch.testing.assert_close(a.diagnostics["losses"], b.diagnostics["losses"], atol=TOL, rtol=0)
        for p, q in zip(_leaves(a), _leaves(b), strict=True):
            torch.testing.assert_close(p, q, atol=TOL, rtol=0)
        for key in ("engine_path", "seed_fold", "scenario_fold"):
            assert a.diagnostics[key] == b.diagnostics[key], key


def _folds(results):
    return {(r.diagnostics["engine_path"], r.diagnostics["device_fold"]) for r in results}


def _misses():
    return {d: s["misses"] for d, s in sessions.session_cache_stats_by_domain().items()}


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("method", list(RUNNERS))
def test_two_slots_equal_the_unsharded_fold(method):
    single = _run(method, (0, 1))
    sharded = _run(method, (0, 1), dataclasses.replace(ITER, mesh=2))
    _assert_same(sharded, single)
    assert (_folds(single), _folds(sharded)) == ({("vmap", 1)}, {("vmap", 2)})


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("slots", [2, 4], ids=["pad-3-to-4-two-slots", "pad-3-to-4-four-slots"])
@pytest.mark.parametrize("method", list(RUNNERS))
def test_padded_folds_equal_the_unsharded_entry_by_entry(method, slots):
    seeds = (0, 1, 2)
    single = _run(method, seeds)
    sharded = _run(method, seeds, dataclasses.replace(ITER, mesh=_mesh(slots)))
    _assert_same(sharded, single)
    assert _folds(sharded) == {("vmap", slots)}


# ------------------------------------------------------------------ (c)
def test_the_stacked_sessions_key_carries_the_mesh_never_the_width():
    sessions.clear_session_cache()
    _run("vanilla", (0, 1))
    warm = _misses()
    assert warm["iterative"] == 1
    sharded = dataclasses.replace(ITER, mesh=2)
    _run("vanilla", (0, 1), sharded)
    first = _misses()
    assert {d: first[d] - warm.get(d, 0) for d in first} == {d: int(d == "iterative") for d in first}
    mesh_keys = [k for k in sessions._SESSION_CACHE if k[0] == "iterative" and k[-1] == (("batch",), (2,))]
    assert len(mesh_keys) == 1

    _run("vanilla", (0, 1, 2), sharded)  # a new width on the same mesh shape
    _run("vanilla", (0, 1, 2), dataclasses.replace(ITER, mesh=_mesh(2)))  # other slots, same key
    _run("vanilla", (0, 1))  # unsharded again
    assert _misses() == first


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("method", list(RUNNERS))
def test_the_per_entry_loop_ignores_the_mesh(method):
    looped = dataclasses.replace(ITER, engine_mode="python")
    want = _run(method, (0, 1), looped)
    before = _misses()
    got = _run(method, (0, 1), dataclasses.replace(looped, mesh=2))
    assert _misses() == before
    _assert_same(got, want)
    assert _folds(got) == {("python", 1)}


# ------------------------------------------------------------------ (e)
@pytest.mark.parametrize("method", list(RUNNERS))
def test_a_faulted_fold_shards_too(method):
    # horizons 30, 60, 15 of 60 steps (FedBCD 6, 12, 3 of 12 rounds): slot 0
    # holds entries 0-1 and first stalls at 30, slot 1 entry 2 and the copy
    # of entry 0, and first stalls at 15
    faults = [FaultSpec("dropout", party=1, stage="post_ssl"), None, FaultSpec("dropout", party=0)]
    seeds = (0, 1, 2)
    single = _run(method, seeds, faults=faults)
    sharded = _run(method, seeds, dataclasses.replace(ITER, mesh=2), faults=faults)
    _assert_same(sharded, single)
    for a, b, fault in zip(sharded, single, faults):
        for key in ("parties_survived", "fault_retry_bytes", "degraded_metric"):
            assert a.diagnostics.get(key) == b.diagnostics.get(key), key
        assert ("fault_kind" in a.diagnostics) == (fault is not None)
    assert _folds(sharded) == {("vmap", 2)}


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("method", list(RUNNERS))
def test_sharded_ledgers_equal_the_references_unsharded_run(method):
    seeds = (0, 1)
    ref = ref_run_seeds(
        REF_RUNNERS[method],
        [jax.random.PRNGKey(s) for s in seeds],
        _ref_splits(seeds),
        [[make_mlp_extractor(rep_dim=8, hidden=(16,)) for _ in range(2)] for _ in seeds],
        [[RefSSL(modality="tabular")] * 2 for _ in seeds],
        RefIterConfig(iterations=10),
    )
    got = _run(method, seeds, IterativeConfig(iterations=10, engine_mode="vmap", mesh=2))
    for g, r in zip(got, ref, strict=True):
        assert events(g.ledger) == events(r.ledger)
        assert g.ledger.summary() == r.ledger.summary()
        assert g.diagnostics["device_fold"] == 2


# ------------------------------------------------------------------ (g)
def test_few_shot_finetune_shards_its_finetune_session():
    seeds = (0, 1, 2, 3)
    n = len(seeds)

    def chain(cfg):
        return run_seeds(
            run_few_shot_finetune, list(seeds), _splits(seeds), [SPECS] * n, [SSL] * n, cfg,
            device="cpu", finetune_iterations=20,
        )

    single = chain(FAST)
    before = _misses()
    sharded = chain(dataclasses.replace(FAST, mesh=2))
    fresh = {d: m - before.get(d, 0) for d, m in _misses().items()}
    assert fresh["iterative"] == 1  # the finetune session's mesh-keyed build
    _assert_parity(sharded, single)
    for a, b in zip(sharded, single):
        torch.testing.assert_close(a.diagnostics["losses"], b.diagnostics["losses"], atol=TOL, rtol=0)
        assert a.diagnostics["fewshot_metric"] == pytest.approx(b.diagnostics["fewshot_metric"], abs=TOL)
        assert a.ledger.comm_times() == 5 + 2 * 20
        got = tuple(a.diagnostics[k] for k in ("finetune_engine_path", "finetune_device_fold"))
        want = tuple(b.diagnostics[k] for k in ("finetune_engine_path", "finetune_device_fold"))
        assert (got, want) == (("vmap", 2), ("vmap", 1))
        assert (a.diagnostics["device_fold"], b.diagnostics["device_fold"]) == (2, 1)


# ------------------------------------------------------------------ (h)
@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")


def test_a_cuda_mesh_without_a_card_is_refused(no_card):
    with pytest.raises(ValueError, match="visible"):
        IterativeConfig(mesh=BatchMesh(("cuda:0", "cuda:0")))
    with pytest.raises(RuntimeError, match="no CUDA device"):  # a slot count on the card's type
        run_seeds(
            run_vanilla, [0, 1], _splits((0, 1)), [SPECS] * 2, [SSL] * 2,
            dataclasses.replace(ITER, mesh=2), device="cuda",
        )


@pytest.mark.parametrize("devices", [("cpu", "cuda:0"), ("cuda:0", "cpu")], ids=["cpu-cuda", "cuda-cpu"])
def test_a_mixed_mesh_is_refused(devices):
    with pytest.raises(ValueError, match="mixes device types"):
        IterativeConfig(mesh=BatchMesh(devices))


def test_a_mesh_that_is_not_one_is_refused():
    with pytest.raises(TypeError, match="a mesh is None, an int or a BatchMesh"):
        _run("vanilla", (0, 1), dataclasses.replace(ITER, mesh="two"))


def test_a_mesh_of_the_other_device_type_is_refused():
    if not torch.cuda.is_available():
        pytest.skip("needs a card: a CUDA mesh over a fold on the CPU")
    cfg = dataclasses.replace(ITER, mesh=BatchMesh(("cuda:0", "cuda:0")))
    with pytest.raises(ValueError, match="cannot shard a fold on cpu"):
        _run("vanilla", (0, 1), cfg)
